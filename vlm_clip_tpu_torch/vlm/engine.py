"""Continuous-batching generation engine for the port's Qwen2.5-VL.

Port of ``vlm_clip_tpu/vlm/engine.py``. The reference's
``VLMContextExtractor`` runs one fixed ``generate()`` batch at a time
(model_v.py:108-118): the batch decodes until its last row finishes, and
new work waits for the whole batch. This engine keeps ``n_slots`` decode
rows resident on the device and treats each as an independent slot,
vLLM-style:

- the host reads results once per decode chunk (a [n, k] token block and
  four [n] state vectors, copied into pinned buffers behind a CUDA
  event); the chunk length k is picked on the host before the chunk
  starts, from the slots' known remaining budgets (see the class
  docstring), and the chunk's k steps run as a Python loop that never
  reads a value back to the host: stops, budgets and ``done`` are tensor
  masks, and a row that is done decodes masked garbage until the chunk
  ends;
- rows that hit a stop token or their budget are harvested and their
  slots refilled from the queue, in same-layout groups that share one
  vision + prefill (``refill_chunks``), whose cache rows are copied into
  the slots with ``index_copy_`` (an int8 cache's scales too);
- decode state is per row: each slot writes its fresh K/V at its own
  depth and attends ``cols < depth`` plus its fresh rows, the per-row
  ``cache_index`` route of ``qwen_model.text_forward``, which reads only
  a ``kv_read_span`` bucket of the cache (a multiple of 128) through K8
  (``ops/decode_attention.py``). Under ``8h4`` the int4 head launches
  K7 at every decode step (M = n_slots <= 32).

Output parity: a request's tokens are those of
``QwenVLGenerator.generate_from_ids`` under greedy decoding (same
prefill, same attended set per step, same stop trim). Sampled chains use
one seeded ``torch.Generator`` per engine.

Cancellation differs from the reference on purpose: a cancelled live
row is stopped by a per-chunk [n_slots] cancel mask that the next
chunk's first step applies, not by an eager write into the device state
between chunks.

The engine is not thread-safe, and K8's per-device workspace is shared
by every call on a device, which must run on one stream: all of an
engine's calls belong on one thread (``cli/serve_vlm.EngineWorker``).

``mesh`` (a ``('data', 'model')`` ``DeviceMesh`` over the process group,
one rank a device): the generator's weights are cut to this rank's
shard by ``qwen_param_rules`` over ``model`` (the reference's
``shard_params``), so each rank's forwards issue the model axis's
collectives; with ``data`` > 1 the slot state and the KV cache shard
over ``data``, each replica decoding its own ``n_slots / data`` slots.
Where the reference runs one SPMD program, every rank here runs the same
host scheduler over all slots, prefills an install group when it owns a
slot of it, decodes its slot shard, and all-gathers each chunk's tokens
and slot state over ``data``, so every rank's host state stays equal
(the caller submits and cancels the same requests on every rank, as
``cli/serve_vlm`` does by broadcast). As in the reference, the engine
takes no ``pipe`` axis.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vlm_clip_tpu_torch.parallel.distributed import gather_rows
from vlm_clip_tpu_torch.parallel.mesh import (DATA_AXIS, PIPE_AXIS,
                                              axis_coordinate, axis_group)
from vlm_clip_tpu_torch.vlm import speculative as _spec
from vlm_clip_tpu_torch.vlm.qwen_model import (cache_kv_heads, init_kv_cache,
                                               text_forward)
from vlm_clip_tpu_torch.vlm.qwen_process import (VisionInputs,
                                                 rope_index_single)
from vlm_clip_tpu_torch.vlm.sampling import (GREEDY, SamplingConfig,
                                             sample_token)


def place_rows(cache, sub, slots: torch.Tensor) -> None:
    """Copy a prefilled group's cache rows (and an int8 cache's scales)
    into ``cache`` at batch rows ``slots``, in place: the [L, n, max_len,
    kv, d] cache takes the group's [L, len(slots), max_len, kv, d]."""
    for name in ("k", "v", "k_scale", "v_scale"):
        dst = getattr(cache, name)
        if dst is not None:
            dst.index_copy_(1, slots, getattr(sub, name))


class _Pending:
    __slots__ = ("req_id", "ids", "vision", "max_new", "pad_text_to",
                 "group_key", "stream")

    def __init__(self, req_id, ids, vision, max_new, pad_text_to,
                 stream=False):
        self.req_id = req_id
        self.ids = ids
        self.vision = vision
        self.max_new = max_new
        self.pad_text_to = pad_text_to
        self.stream = stream
        # requests sharing a layout (same prompt, same patch shapes and
        # grid) can share one batched vision + prefill
        self.group_key = (ids.tobytes(), vision.grid,
                          vision.patches.shape, pad_text_to)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a ``QwenVLGenerator``.

    ``n_slots``: decode rows resident on the device (one KV cache of
    [L, n_slots, max_len, kv, d]). ``sync_steps``: the least decode steps
    per host read (the fixed chunk length with ``adaptive=False``).
    ``refill_chunks``: prefill group sizes, largest first.

    Adaptive chunking (default): the host knows every slot's remaining
    budget (install sets it, each harvest refreshes it), so each chunk
    ends when the earliest-finishing slot can free (the least remaining
    budget) while requests wait, else at the latest (the most); clamped
    to [sync_steps, chunk_max], and to sync_steps while a streaming
    request is live. Chunk boundaries never enter the math: tokens do
    not change with the chunk lengths.

    Pipelined dispatch (default): chunk N+1 is launched before chunk N's
    results are read, so the host's work of reading them and refilling
    overlaps the device's work. Two sets of pinned host buffers
    alternate, so chunk N+1's copies never overwrite what chunk N's
    harvest reads. A slot freed by chunk N is refilled after N+1 is
    launched, so it idles through N+1; tokens do not change.

    ``mesh``: tensor and data parallelism (see the module docstring).
    """

    def __init__(self, gen, n_slots: int = 32, sync_steps: int = 16,
                 sampling: Optional[SamplingConfig] = None,
                 seed: int = 0,
                 refill_chunks: Tuple[int, ...] = (8, 4, 2, 1),
                 profile: bool = False, spec_k: int = 0,
                 mesh=None, pipeline: bool = True,
                 adaptive: bool = True,
                 chunk_max: Optional[int] = None):
        self.gen = gen
        self.cfg = gen.cfg
        self.device = gen.device
        self.n_slots = n_slots
        self.mesh = mesh
        # this rank's slot shard [_lo, _lo + n_local) of the data axis
        self._dgroup, dp_rank, dp = None, 0, 1
        if mesh is not None:
            from vlm_clip_tpu_torch.parallel.sharding import (
                qwen_head_dims, qwen_param_rules, shard_params)

            if not hasattr(mesh, "mesh_dim_names"):
                raise TypeError(f"mesh must be a torch DeviceMesh "
                                f"(parallel.mesh.create_mesh), got "
                                f"{type(mesh).__name__}")
            if PIPE_AXIS in (mesh.mesh_dim_names or ()):
                raise ValueError("the engine takes a ('data', 'model') "
                                 "mesh, no 'pipe' axis")
            gen.params = shard_params(gen.params, mesh,
                                      rules=qwen_param_rules(),
                                      head_dim=qwen_head_dims(gen.cfg))
            dp_rank, dp = axis_coordinate(mesh, DATA_AXIS)
            if dp > 1:
                if n_slots % dp:
                    raise ValueError(
                        f"n_slots ({n_slots}) must be divisible by the "
                        f"mesh data axis ({dp}) to shard slot state")
                self._dgroup = axis_group(mesh, DATA_AXIS)
        self.n_local = n_slots // dp
        self._lo = dp_rank * self.n_local
        self.sync_steps = sync_steps
        self.adaptive = bool(adaptive)
        self.chunk_max = max(int(chunk_max) if chunk_max
                             else 8 * sync_steps, sync_steps)
        # the most steps one chunk runs (the token buffers' width)
        self._cap = self.chunk_max if self.adaptive else sync_steps
        # n-gram speculative decoding: K drafts verified a forward
        # (vlm/speculative.py); lossless under greedy and sampled configs
        self.spec_k = int(spec_k)
        # phase attribution: a device sync after each install and chunk
        # (measurement only)
        self.profile = profile
        self.pipeline = bool(pipeline) and not profile
        self._pend: Optional[dict] = None
        self.stats = {"install_s": 0.0, "steps_s": 0.0, "sync_s": 0.0,
                      "installs": 0, "steps": 0,
                      # decode rounds (spec: one K+1-token verify forward
                      # each) and chunks (one host read each) dispatched
                      "rounds": 0, "chunks": 0}
        self.scfg = sampling or GREEDY
        self.refill_chunks = tuple(
            c for c in sorted(set(refill_chunks), reverse=True)
            if c <= n_slots) or (1,)
        self._stops = (self.cfg.eos_token_id,) + tuple(self.scfg.extra_eos)

        # --- device state --------------------------------------------------
        # (this rank's slot shard; every slot without a data axis)
        dev = self.device
        n = self.n_local
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self.cache = init_kv_cache(
            self.cfg.text, n, gen.max_len, gen.dtype, gen.kv_quantized,
            device=dev, kv_heads=cache_kv_heads(gen.params["text"],
                                                self.cfg.text))
        self._rows = torch.arange(n, device=dev)
        self.tokens = torch.zeros(n, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(n, dtype=torch.int64, device=dev)
        self.lengths = torch.zeros(n, dtype=torch.int64, device=dev)
        self.done = torch.ones(n, dtype=torch.bool, device=dev)  # free
        self.remaining = torch.zeros(n, dtype=torch.int64, device=dev)
        pdim = self.cfg.text.vocab_size if self.scfg.needs_presence else 1
        self.presence = torch.zeros(n, pdim, dtype=torch.bool, device=dev)
        if self.spec_k:
            # each slot's prompt + generated window for the n-gram lookup
            # (+1 scrap column for masked writes)
            self.hist = torch.zeros(n, gen.max_len + 1, dtype=torch.int64,
                                    device=dev)
            self.gen_count = torch.zeros(n, dtype=torch.int64, device=dev)
        # a chunk's token block: k steps (spec: k rounds of up to K+1
        # tokens, plus a scrap column)
        self._buf_cols = (self._cap * (self.spec_k + 1) + 1 if self.spec_k
                          else self._cap)
        self._host_sets = [self._host_set() for _ in range(2)]
        self._flip = 0

        # --- host state ----------------------------------------------------
        self._queue: "collections.deque[_Pending]" = collections.deque()
        self._slot_req: List[Optional[int]] = [None] * n_slots
        self._slot_stream: List[bool] = [False] * n_slots
        self._slot_toks: List[List[int]] = [[] for _ in range(n_slots)]
        self._lengths_host = np.zeros((n_slots,), np.int64)
        # each slot's remaining budget through the last harvest (drives
        # the adaptive chunk length)
        self._remaining_host = np.zeros((n_slots,), np.int64)
        # live slots cancelled since the last dispatch: the next chunk's
        # first step stops them
        self._cancel = np.zeros((n_slots,), bool)
        self._next_id = 0
        self._finished: Dict[int, List[int]] = {}

    def _host_set(self) -> dict:
        """One set of host buffers a chunk's results land in (pinned on
        the card, so the copies run behind the device's work), with the
        event that says they have."""
        n = self.n_slots
        cuda = self.device.type == "cuda"

        def host(*shape, dtype=torch.int64):
            return torch.empty(shape, dtype=dtype, pin_memory=cuda)

        return {"buf": host(n, self._buf_cols), "lengths": host(n),
                "done": host(n, dtype=torch.bool), "remaining": host(n),
                "tokens": host(n), "cancel": host(n, dtype=torch.bool),
                "event": torch.cuda.Event() if cuda else None}

    def _to_device(self, a) -> torch.Tensor:
        """A host array on the engine's device without waiting for it (a
        pinned copy behind the device's queue on the card)."""
        t = torch.from_numpy(np.array(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------
    def submit(self, ids: np.ndarray, vision: VisionInputs,
               max_new_tokens: int = 200,
               pad_text_to: Optional[int] = None,
               stream: bool = False) -> int:
        """Queue one request; returns its id (see poll()/flush()).

        ``stream=True`` marks a streaming consumer (partial_tokens):
        while one is live, the adaptive chunk length is capped at
        ``sync_steps`` so its tokens reach the host at that granularity.
        Tokens do not change."""
        T_p = pad_text_to or len(ids)
        if T_p + max_new_tokens > self.gen.max_len:
            raise ValueError(
                f"prompt ({T_p} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine KV max_len "
                f"({self.gen.max_len})")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(rid, np.asarray(ids), vision,
                                    max_new_tokens, pad_text_to,
                                    stream=stream))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(
            r is not None for r in self._slot_req)

    def poll(self) -> Dict[int, List[int]]:
        """One scheduling round; returns the requests finished in it.

        Unpipelined: refill free slots, run one chunk, harvest it.
        Pipelined (default): dispatch chunk N+1 from the state chunk N
        leaves on the device, then harvest chunk N (its read and the
        refill's host work overlap chunk N+1 on the device), then refill.
        When chunk N already spends every live slot's budget, N+1 would
        be all garbage: chunk N is harvested and the freed slots refilled
        first.
        """
        if not self.pipeline:
            self._refill()
            if any(r is not None for r in self._slot_req):
                self._harvest(self._dispatch())
        else:
            prev = self._pend
            if any(self._needs_chunk(s, r)
                   for s, r in enumerate(self._slot_req) if r is not None):
                # _dispatch sizes its chunk and span from prev, in flight
                self._pend = self._dispatch()
            else:
                self._pend = None
            if prev is not None:
                self._harvest(prev)
            self._refill()
        out, self._finished = self._finished, {}
        return out

    def flush(self) -> Dict[int, List[int]]:
        """Run until queue and slots drain; returns all results."""
        results: Dict[int, List[int]] = {}
        while self.pending:
            results.update(self.poll())
        if self._pend is not None:
            # a chunk launched before its rows were seen to finish early
            self._harvest(self._pend)
            self._pend = None
        return results

    def progress(self) -> Dict[int, int]:
        """Tokens harvested so far per live (installed, unfinished)
        request, from the host's copies (no device read; lags the device
        by at most the chunk in flight). Finished requests are returned
        by poll(); queued ones do not appear."""
        return {rid: len(self._slot_toks[s])
                for s, rid in enumerate(self._slot_req) if rid is not None}

    def cancel(self, rid: int) -> bool:
        """Abort a request (a client that went away). Queued: dropped
        before install. Live: the slot is freed for the next refill, and
        its row is stopped by the next chunk's cancel mask (until then
        it is a finished-but-unharvested row, whose outputs are dropped).
        Returns True if the request was found; a cancelled request is
        never reported by poll()."""
        for p in self._queue:
            if p.req_id == rid:
                self._queue.remove(p)
                return True
        for s, r in enumerate(self._slot_req):
            if r == rid:
                self._slot_req[s] = None
                self._slot_stream[s] = False
                self._slot_toks[s] = []
                self._remaining_host[s] = 0
                self._cancel[s] = True
                return True
        return False

    def partial_tokens(self, rid: int) -> Optional[List[int]]:
        """Copy of a live request's harvested tokens, or None when it is
        not in a slot (still queued, or finished and returned by poll).
        Harvested tokens are final (chunks only append), so a streaming
        consumer can ship deltas."""
        for s, r in enumerate(self._slot_req):
            if r == rid:
                return list(self._slot_toks[s])
        return None

    # ------------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _refill(self):
        free = self._free_slots()
        while self._queue and free:
            # the queue head with same-layout requests behind it
            head = self._queue[0]
            group = [head]
            cap = min(len(free), max(
                (c for c in self.refill_chunks if c <= len(free)),
                default=1))
            for p in list(self._queue)[1:]:
                if len(group) >= cap:
                    break
                if p.group_key == head.group_key:
                    group.append(p)
            # the largest refill chunk that fits the group
            size = next((c for c in self.refill_chunks
                         if c <= len(group)), 1)
            group = group[:size]
            for p in group:
                self._queue.remove(p)
            self._install(group, free[:size])
            free = free[size:]

    @torch.no_grad()
    def _install(self, group: List[_Pending], slots: List[int]):
        """One batched vision + prefill for a same-layout group, its
        cache rows copied into ``slots`` and each slot's state reset.
        The prep mirrors ``QwenVLGenerator.prefill_batch``. Under a data
        axis a rank prefills the group only when it owns one of
        ``slots``, and keeps the rows of those it owns."""
        gen = self.gen
        cfg = self.cfg
        t0 = time.perf_counter() if self.profile else 0.0
        head = group[0]
        ids, v0 = head.ids, head.vision
        T = len(ids)
        mine = [(i, s - self._lo) for i, s in enumerate(slots)
                if 0 <= s - self._lo < self.n_local]
        if mine:
            pos, delta = rope_index_single(ids, v0.grid, cfg)
            patches = np.stack([p.vision.patches for p in group])
            wmask, fmask = gen._mask_args(v0)
            img_slots = np.nonzero(ids == cfg.image_token_id)[0]
            rev, img_slots = gen._pad_slots(v0, img_slots)
            ids_p, pos_p = (gen._pad_text(ids, np.asarray(pos),
                                          head.pad_text_to)
                            if head.pad_text_to else (ids, np.asarray(pos)))
            c = len(group)
            sub = gen._new_cache(c)
            pos3 = np.broadcast_to(pos_p[:, None, :], (3, c, len(ids_p)))
            logits0, sub = gen._embed_prefill(
                self._to_device(patches), self._to_device(v0.rot_pos_emb),
                wmask, fmask, self._to_device(rev), self._to_device(ids_p),
                self._to_device(img_slots), self._to_device(pos3), sub,
                T - 1, uw=v0.uniform_window)

            rows = [i for i, _ in mine]
            n = len(rows)
            sl = self._to_device(np.asarray([j for _, j in mine], np.int64))
            if n < c:  # the group rows of this rank's slots
                pick = self._to_device(np.asarray(rows, np.int64))
                for name in ("k", "v", "k_scale", "v_scale"):
                    t = getattr(sub, name)
                    if t is not None:
                        setattr(sub, name, t.index_select(1, pick))
            place_rows(self.cache, sub, sl)
            del sub
            pdim = self.presence.shape[1]
            prow = np.zeros((pdim,), bool)
            if self.scfg.needs_presence:
                prow[np.unique(ids)] = True
            pres = self._to_device(np.broadcast_to(prow, (c, pdim)))
            tok0 = sample_token(logits0, pres, self._gen, self.scfg)
            if n < c:
                tok0, pres = tok0[pick], pres[pick]
            self.presence.index_copy_(0, sl, pres)
            self.tokens.index_copy_(0, sl, tok0)
            self.pos.index_fill_(0, sl, int(T + delta))
            self.lengths.index_fill_(0, sl, T)
            self.done.index_fill_(0, sl, False)
            self.remaining.index_copy_(0, sl, self._to_device(
                np.asarray([group[i].max_new for i in rows], np.int64)))
            if self.spec_k:
                # seed the n-gram window with the prompt (prompt lookup
                # proper): the group shares one prompt; gen_count is the
                # window's valid tokens, the offset recorded tokens land
                # at
                H = self.hist.shape[1] - 1
                seed = np.zeros((H + 1,), np.int64)
                npids = np.asarray(ids[:H], np.int64)
                seed[:len(npids)] = npids
                self.hist.index_copy_(0, sl, self._to_device(
                    np.broadcast_to(seed, (n, H + 1))))
                self.gen_count.index_fill_(0, sl, len(npids))
        self._cancel[slots] = False  # the old rows are gone
        if self.profile:
            self._sync()
            self.stats["install_s"] += time.perf_counter() - t0
            self.stats["installs"] += len(group)
        for p, s in zip(group, slots):
            self._slot_req[s] = p.req_id
            self._slot_stream[s] = p.stream
            self._slot_toks[s] = []
            self._lengths_host[s] = T
            self._remaining_host[s] = p.max_new

    def _inflight(self, s: int, rid: Optional[int]) -> int:
        """Steps the chunk in flight runs for request ``rid`` in slot
        ``s`` (0 when it was dispatched before ``rid`` was installed).
        Each step records at least one of the row's tokens until it is
        done."""
        pend = self._pend
        if pend is None or pend["slot_req"][s] != rid:
            return 0
        return pend["k"]

    def _needs_chunk(self, s: int, rid: int) -> bool:
        """Whether a chunk after the one in flight can still record a
        token of (or finish) request ``rid`` in slot ``s``."""
        k = self._inflight(s, rid)
        return k == 0 or self._remaining_host[s] > k

    def _kv_span(self, k_next: int) -> int:
        """The cache columns the next chunk reads: the deepest live slot
        after the chunk in flight and the next one, rounded up to 128 (so
        K8's S >= 128 holds), at most max_len. The host's depths lag the
        chunk in flight, so its length is part of the margin."""
        grow = 1 + self.spec_k
        deepest = max((int(self._lengths_host[s])
                       + self._inflight(s, r) * grow
                       for s, r in enumerate(self._slot_req)
                       if r is not None), default=0)
        need = deepest + k_next * grow
        return min(self.gen.max_len, -(-need // 128) * 128)

    def _next_chunk(self) -> int:
        """The next chunk's length (see the class docstring). Remaining
        budgets are exact through the last harvest; the chunk in flight
        spends at least one token of a live row a step."""
        if not self.adaptive:
            return self.sync_steps
        rem = [int(self._remaining_host[s]) - self._inflight(s, r)
               for s, r in enumerate(self._slot_req) if r is not None]
        rem = [x for x in rem if x > 0]
        tgt = (min(rem) if self._queue else max(rem)) if rem else 0
        if any(self._slot_stream[s]
               for s, r in enumerate(self._slot_req) if r is not None):
            tgt = min(tgt, self.sync_steps)
        return max(self.sync_steps, min(self.chunk_max, tgt))

    @torch.no_grad()
    def _dispatch(self) -> dict:
        """Launch one decode chunk and the copies of its results into a
        host buffer set; returns them with the slot assignment's snapshot
        for its harvest. Nothing here waits on the device."""
        t0 = time.perf_counter() if self.profile else 0.0
        k = self._next_chunk()
        span = self._kv_span(k)
        self.stats["rounds"] += k
        self.stats["chunks"] += 1
        hs = self._host_sets[self._flip]
        self._flip ^= 1
        cancel = None
        if self._cancel.any():
            hs["cancel"].copy_(torch.from_numpy(self._cancel))
            cancel = hs["cancel"][self._lo:self._lo + self.n_local].to(
                self.device, non_blocking=True)
            self._cancel[:] = False
        buf = (self._spec_steps if self.spec_k else self._steps)(
            k, span, cancel)
        # the chunk's results, behind its work on the device's queue; the
        # next chunk's results go to the other set
        cuda = hs["event"] is not None
        state = (("buf", buf), ("lengths", self.lengths),
                 ("done", self.done), ("remaining", self.remaining),
                 ("tokens", self.tokens))
        if self._dgroup is not None:
            state = self._gather_slots(state)
        for name, t in state:
            hs[name].copy_(t, non_blocking=cuda)
        if cuda:
            hs["event"].record()
        if self.profile:
            self._sync()
            self.stats["steps_s"] += time.perf_counter() - t0
            self.stats["steps"] += k
        # slots refilled after this dispatch must not take this chunk's
        # rows (they hold the previous request's state): the harvest
        # checks that the snapshot's request is still the slot's
        return {"host": hs, "slot_req": list(self._slot_req), "k": k}

    def _gather_slots(self, state):
        """Every data replica's slot shard of the chunk's results, in slot
        order: one all-gather of them packed as int64 columns."""
        cols = [t.reshape(self.n_local, -1).to(torch.int64)
                for _, t in state]
        out = gather_rows(torch.cat(cols, dim=1), self._dgroup)
        res, i = [], 0
        for (name, t), c in zip(state, cols):
            w = c.shape[1]
            res.append((name, out[:, i:i + w].reshape(
                self.n_slots, *t.shape[1:]).to(t.dtype)))
            i += w
        return res

    def _steps(self, k: int, span: int, cancel) -> torch.Tensor:
        """k decode steps over every slot; done and free rows compute
        garbage that is never recorded. Each step records the current
        token (stop and budget checked), then forwards it: its K/V row
        lands at depth ``lengths`` and it attends ``cols <= lengths``."""
        n = self.n_local
        eos = self.cfg.eos_token_id
        params = self.gen.params["text"]
        tokens, pos, lengths = self.tokens, self.pos, self.lengths
        done, remaining = self.done, self.remaining
        if cancel is not None:
            done = done | cancel
            remaining = remaining.masked_fill(cancel, 0)
        buf = torch.full((n, self._buf_cols), eos, dtype=torch.int64,
                         device=self.device)
        for i in range(k):
            done = (done | _spec.stop_mask(tokens, self._stops)
                    | (remaining <= 0))
            buf[:, i] = torch.where(done, eos, tokens)
            rec = (~done).to(torch.int64)
            if self.scfg.needs_presence:
                self.presence[self._rows, tokens] = True
            remaining = remaining - rec
            emb = params["embed_tokens"][tokens][:, None]
            pos3 = pos[None, :, None].expand(3, n, 1)
            # mask=None: the canonical decode mask, K8's route
            logits, self.cache = text_forward(
                params, emb.to(self.gen.dtype), pos3, self.cfg.text, None,
                self.cache, lengths, kv_read_span=span, impl=self.gen.impl)
            nxt = sample_token(logits[:, -1], self.presence, self._gen,
                               self.scfg)
            tokens = torch.where(done, tokens, nxt)
            pos = pos + rec
            lengths = lengths + rec
        self.tokens, self.pos, self.lengths = tokens, pos, lengths
        self.done, self.remaining = done, remaining
        return buf

    def _spec_steps(self, k: int, span: int, cancel) -> torch.Tensor:
        """k speculative verify rounds over every slot. Each round
        records the carried token, forwards [carried, draft_1..draft_K]
        (T = K+1 at per-row depths; the block's K/V rows land at
        lengths..lengths+K), records the accepted drafts and carries the
        model's next token: a accepted drafts emit a+1 tokens for one
        pass over the weights. ``buf`` packs each row's tokens from
        column 0 (the last column is scrap for masked writes)."""
        n, K = self.n_local, self.spec_k
        eos = self.cfg.eos_token_id
        params = self.gen.params["text"]
        rows = self._rows
        cap = self._buf_cols - 1
        H = self.hist.shape[1] - 1
        hist, presence = self.hist, self.presence
        tokens, pos, lengths = self.tokens, self.pos, self.lengths
        done, remaining = self.done, self.remaining
        gen_count = self.gen_count
        if cancel is not None:
            done = done | cancel
            remaining = remaining.masked_fill(cancel, 0)
        buf = torch.full((n, cap + 1), eos, dtype=torch.int64,
                         device=self.device)
        bufcnt = torch.zeros(n, dtype=torch.int64, device=self.device)
        offs = torch.arange(K + 1, device=self.device)
        for _ in range(k):
            done = (done | _spec.stop_mask(tokens, self._stops)
                    | (remaining <= 0))
            recb = ~done
            rec = recb.to(torch.int64)
            # record the carried token
            buf[rows, torch.where(recb, bufcnt.clamp(max=cap), cap)] = tokens
            hist[rows, torch.where(recb, gen_count.clamp(max=H), H)] = tokens
            bufcnt = bufcnt + rec
            gen_count = gen_count + rec
            remaining = remaining - rec

            draft = _spec.ngram_draft(hist[:, :H], gen_count, K)
            emb = params["embed_tokens"][torch.cat([tokens[:, None], draft],
                                                   dim=1)]
            pos3 = pos[None, :, None].expand(3, n, 1) + offs[None, None]
            # mask=None: the canonical decode mask (cache cols < depth,
            # causal over the verify block), K8's route
            logits, self.cache = text_forward(
                params, emb.to(self.gen.dtype), pos3, self.cfg.text, None,
                self.cache, lengths, kv_read_span=span, impl=self.gen.impl)
            a, cand = _spec.verify_round(draft, logits, tokens, presence,
                                         self._gen, self.scfg, self._stops)
            m = torch.where(recb, torch.minimum(a, remaining.clamp(min=0)),
                            0)
            if self.scfg.needs_presence:
                # x0 (recorded this round) and the accepted drafts; the
                # carried token is recorded at the next round's top
                presence[rows, tokens] = True
            for j in range(K):
                w = j < m
                buf[rows, torch.where(w, (bufcnt + j).clamp(max=cap),
                                      cap)] = draft[:, j]
                hist[rows, torch.where(w, (gen_count + j).clamp(max=H),
                                       H)] = draft[:, j]
                if self.scfg.needs_presence:
                    presence[rows, draft[:, j]] |= w
            bufcnt = bufcnt + m
            gen_count = gen_count + m
            remaining = remaining - m
            newtok = cand.gather(1, m[:, None])[:, 0]
            tokens = torch.where(recb, newtok, tokens)
            adv = torch.where(recb, 1 + m, 0)
            pos = pos + adv
            lengths = lengths + adv
        self.tokens, self.pos, self.lengths = tokens, pos, lengths
        self.done, self.remaining = done, remaining
        self.gen_count = gen_count
        return buf

    def _harvest(self, pend: dict):
        """Read a dispatched chunk's results and record or finish its
        rows: the one wait on the device; under pipelined dispatch the
        next chunk is already on the device's queue."""
        t0 = time.perf_counter() if self.profile else 0.0
        hs = pend["host"]
        if hs["event"] is not None:
            hs["event"].synchronize()
        buf_h = hs["buf"].numpy()
        lengths_h = hs["lengths"].numpy()
        done_h = hs["done"].numpy()
        remaining_h = hs["remaining"].numpy()
        stop_h = np.isin(hs["tokens"].numpy(), np.asarray(self._stops))
        if self.profile:
            self.stats["sync_s"] += time.perf_counter() - t0
        for s, rid in enumerate(pend["slot_req"]):
            if rid is None or self._slot_req[s] != rid:
                continue  # freed or refilled since dispatch
            # the depth through the last harvested chunk, so the delta is
            # this chunk's tokens (its buffer rows start at column 0)
            rec = int(lengths_h[s] - self._lengths_host[s])
            self._lengths_host[s] = lengths_h[s]
            self._remaining_host[s] = remaining_h[s]
            if rec:
                self._slot_toks[s].extend(buf_h[s, :rec].tolist())
            if done_h[s] or stop_h[s] or remaining_h[s] <= 0:
                self._finished[rid] = self._slot_toks[s]
                self._slot_req[s] = None
                self._slot_stream[s] = False
                self._slot_toks[s] = []
