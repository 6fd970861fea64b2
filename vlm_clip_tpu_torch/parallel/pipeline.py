"""Pipeline parallelism for the Qwen text decoder: GPipe prefill and
token-ring decode (port of ``vlm_clip_tpu/parallel/pipeline.py``).

The stacked layers ``[L, ...]`` split into ``S`` contiguous stages
(:func:`split_stages`), one a ``pipe`` rank; each rank holds its stage's
layers (:func:`shard_staged`; with ``tp_rules`` on a ``('pipe',
'model')`` mesh, its tensor-parallel shard of them) and the replicated
embedding, final norm and head. Where the reference's ``shard_map``
moves activations with ``ppermute`` over ``pipe``, the port sends them
point to point from stage s to stage s + 1 on the axis's process group:

- prefill (GPipe): ``M == S`` microbatches; at tick t stage s runs
  microbatch t - s through its layers when 0 <= t - s < M (a bubble tick
  runs nothing, so it writes no cache row), the last stage keeping the
  head's logits of each microbatch's last position;
- decode (token ring): at tick t stage s runs microbatch (t - s) mod S
  at step (t - s) // S; the token sampled at the last stage rides the
  ring back to stage 0, which embeds it one tick later. A bubble tick
  writes the cache's last row, a scratch row that ``max_len >= T +
  max_new + 1`` keeps off the live ones (the reference's contract). The
  last stage keeps the token buffer, the stop state and the repetition
  penalty's presence table, and broadcasts the buffers at the end.

Each stage runs the port's ``text_decoder_layer``: K8 decodes inside a
stage and K7 runs an int4 head on the last. Sampled streams are the
port's own (one seeded ``torch.Generator`` on the last stage), as the
reference documents its pipelined key stream as distinct from the
single-device one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from vlm_clip_tpu_torch.bridge import tree_leaves, tree_map
from vlm_clip_tpu_torch.parallel.mesh import (MODEL_AXIS, PIPE_AXIS,
                                              axis_coordinate, axis_group)
from vlm_clip_tpu_torch.vlm.qwen_model import (QwenTextConfig, cache_kv_heads,
                                               layer, linear, mrope_cos_sin,
                                               rms_norm, text_decoder_layer)
from vlm_clip_tpu_torch.vlm.sampling import (GREEDY, SamplingConfig,
                                             sample_token)

_NEG = float(torch.finfo(torch.float32).min)


def split_stages(text_params: Dict[str, Any], n_stages: int
                 ) -> Dict[str, Any]:
    """The stacked layers ``[L, ...]`` as ``[S, L//S, ...]`` (views);
    the other leaves unchanged."""
    L = tree_leaves(text_params["layers"])[0].shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible by {n_stages} stages")
    out = dict(text_params)
    out["layers"] = tree_map(
        lambda a: a.reshape((n_stages, L // n_stages) + a.shape[1:]),
        text_params["layers"])
    return out


def shard_staged(staged_params: Dict[str, Any], mesh, tp_rules=None,
                 head_dim: Optional[Dict[str, int]] = None
                 ) -> Dict[str, Any]:
    """This rank's stage of a :func:`split_stages` tree: its ``[L//S,
    ...]`` layers (a copy when there are other stages, so theirs can be
    freed), cut by ``tp_rules`` over the mesh's ``model`` axis when it
    has one of size > 1 (the stacked rules apply to the stage's stacked
    layers), and the other leaves whole (the reference replicates
    them). ``head_dim``: {path prefix: head width}, as
    ``parallel.sharding.cut_params`` takes it, needed with ``tp_rules``."""
    from vlm_clip_tpu_torch.parallel.sharding import cut_params

    s, n_stages = axis_coordinate(mesh, PIPE_AXIS)
    layers = tree_map(lambda a: a[s].clone() if n_stages > 1 else a[s],
                      staged_params["layers"])
    rank, size = axis_coordinate(mesh, MODEL_AXIS)
    if tp_rules is not None and size > 1:
        if head_dim is None:
            raise ValueError("tp_rules need head_dim ({path prefix: head "
                             "width})")
        layers = cut_params({"layers": layers}, tp_rules,
                            {MODEL_AXIS: size}, {MODEL_AXIS: rank}, head_dim,
                            {MODEL_AXIS: axis_group(mesh, MODEL_AXIS)}
                            )["layers"]
    out = dict(staged_params)
    out["layers"] = layers
    return out


class PipeKVCache(NamedTuple):
    """This stage's KV cache: ``[L//S, M, mb, max_len, kv, d]`` (the
    reference's is the stage-sharded ``[S, L//S, M, mb, max_len, kv,
    d]``; kv: this rank's heads)."""
    k: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class PipelineGenerator:
    """Stage-sharded prefill and token-ring decode over a ``pipe`` mesh
    (see the module docstring). Every rank of the mesh calls the same
    public method with the same arguments; each returns the results.

    The contract mirrors ``QwenVLGenerator`` at the embeds level: the
    caller supplies microbatched sequence embeddings (text embeds with
    the vision features scattered in: ``QwenVLGenerator.embed_sequence``)
    and gets token buffers with the reference's eos trim. Constraints
    (raised): ``n_micro == n_stages``, layers divisible by stages,
    ``max_len >= T + max_new + 1`` (the scratch row), and
    ``prompt_ids`` with a repetition penalty.
    """

    params: Dict[str, Any]       # this rank's stage (see from_params)
    cfg: QwenTextConfig
    mesh: Any
    eos_token_id: int
    max_len: int = 1536
    dtype: Any = torch.bfloat16

    @classmethod
    def from_params(cls, text_params: Dict[str, Any], cfg: QwenTextConfig,
                    mesh, eos_token_id: int, max_len: int = 1536,
                    dtype=torch.bfloat16,
                    tp_rules=None) -> "PipelineGenerator":
        """``tp_rules`` (e.g. ``qwen_param_rules()``) with a ``('pipe',
        'model')`` mesh: tensor parallelism within each stage."""
        _, S = axis_coordinate(mesh, PIPE_AXIS)
        staged = shard_staged(split_stages(text_params, S), mesh,
                              tp_rules=tp_rules,
                              head_dim={"": cfg.head_dim})
        return cls(staged, cfg, mesh, eos_token_id, max_len, dtype)

    @property
    def n_stages(self) -> int:
        return axis_coordinate(self.mesh, PIPE_AXIS)[1]

    @property
    def stage(self) -> int:
        return axis_coordinate(self.mesh, PIPE_AXIS)[0]

    @property
    def device(self) -> torch.device:
        return self.params["embed_tokens"].device

    # -- the ring ---------------------------------------------------------

    def _peer(self, offset: int) -> int:
        group = axis_group(self.mesh, PIPE_AXIS)
        return dist.get_global_rank(group,
                                    (self.stage + offset) % self.n_stages)

    def _shift(self, tensors, ring: bool):
        """Send ``tensors`` to the next stage and receive the previous
        stage's (the last stage sends to stage 0 only on a ``ring``)."""
        S, s = self.n_stages, self.stage
        if S == 1:
            return list(tensors) if ring else [None] * len(tensors)
        group = axis_group(self.mesh, PIPE_AXIS)
        ops, got = [], []
        if ring or s < S - 1:
            ops += [dist.P2POp(dist.isend, t.contiguous(), self._peer(1),
                               group) for t in tensors]
        if ring or s > 0:
            got = [torch.empty_like(t) for t in tensors]
            ops += [dist.P2POp(dist.irecv, t, self._peer(-1), group)
                    for t in got]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return got or [None] * len(tensors)

    # -- stage compute ----------------------------------------------------

    def _layers(self, x, cos, sin, mask, cache: PipeKVCache, m: int, idx):
        for i in range(cache.k.shape[0]):
            x, _ = text_decoder_layer(
                layer(self.params["layers"], i), x, cos, sin, mask,
                self.cfg, (cache.k[i, m], cache.v[i, m], None, None), idx)
        return x

    def _head(self, y: torch.Tensor) -> torch.Tensor:
        """Final norm and LM head on the last position: fp32 [mb, V]."""
        cfg = self.cfg
        h = rms_norm(self.params["final_norm"], y[:, -1:], cfg.rms_norm_eps)
        if cfg.tie_word_embeddings:
            w = self.params["embed_tokens"].to(h.dtype)
            return torch.matmul(h[:, 0], w.T).float()
        return linear(self.params["lm_head"], h[:, 0],
                      out_dtype=torch.float32)

    @torch.no_grad()
    def _run(self, embeds, cos, sin, pos_start, T: int, pres, seed: int,
             max_new: int, scfg: SamplingConfig):
        cfg, S, s = self.cfg, self.n_stages, self.stage
        M, mb, _, H = embeds.shape
        dev, dtype, max_len = self.device, self.dtype, self.max_len
        last = s == S - 1
        Ls = tree_leaves(self.params["layers"])[0].shape[0]
        shape = (Ls, M, mb, max_len, cache_kv_heads(self.params, cfg),
                 cfg.head_dim)
        cache = PipeKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros(shape, dtype=dtype, device=dev))
        gen = torch.Generator(device=dev).manual_seed(seed)

        # ---- prefill: GPipe over M microbatches ------------------------
        cols = torch.arange(max_len, device=dev)
        allowed = cols[None, :] <= torch.arange(T, device=dev)[:, None]
        pmask = torch.where(allowed, 0.0, _NEG)[None, None]
        lastlog = [None] * M
        act = None
        for t in range(M + S - 1):
            m = t - s
            y = torch.zeros((mb, T, H), dtype=dtype, device=dev)
            if 0 <= m < M:
                x = embeds[m] if s == 0 else act
                y = self._layers(x, cos[m], sin[m], pmask, cache, m, 0)
                if last:
                    lastlog[m] = self._head(y)
            act, = self._shift([y], ring=False)

        # ---- token 0 at the last stage, shipped to stage 0 -------------
        tok0 = torch.zeros((M, mb), dtype=torch.int64, device=dev)
        if last:
            tok0 = torch.stack([sample_token(lastlog[m], pres[m], gen, scfg)
                                for m in range(M)])
        if S > 1 and s in (0, S - 1):
            group = axis_group(self.mesh, PIPE_AXIS)
            if last:
                dist.send(tok0, self._peer(1), group)
            else:
                dist.recv(tok0, self._peer(-1), group)

        # ---- decode: token ring, M == S --------------------------------
        stops = torch.tensor((self.eos_token_id,) + tuple(scfg.extra_eos),
                             device=dev)
        buf = torch.full((M, mb, max_new), self.eos_token_id,
                         dtype=torch.int64, device=dev)
        done = torch.zeros((M, mb), dtype=torch.bool, device=dev)
        n_out = torch.zeros((M, mb), dtype=torch.int64, device=dev)
        rows = torch.arange(mb, device=dev)
        act = torch.zeros((mb, 1, H), dtype=dtype, device=dev)
        tok_carry = torch.zeros((mb,), dtype=torch.int64, device=dev)
        for t in range(S * max_new + S - 1):
            m, k = (t - s) % S, (t - s) // S
            valid = t >= s and k < max_new
            # the token rides the ring with its activation: stage 0 embeds
            # tok0 at step 0, else what the last stage sampled a tick ago
            tok_in = tok0[m] if s == 0 and k == 0 else tok_carry
            if s == 0:
                act = self.params["embed_tokens"][tok_in][:, None].to(dtype)
            pos = torch.full((3, 1, 1), int(pos_start[m]) + k, device=dev)
            dcos, dsin = mrope_cos_sin(pos, cfg.head_dim, cfg.rope_theta,
                                       cfg.mrope_section)
            idx = T + k if valid else max_len - 1  # bubbles: scratch row
            # mask=None: the canonical decode mask (columns < idx and the
            # fresh row), K8's route
            y = self._layers(act, dcos, dsin, None, cache, m, idx)
            tok_out = tok_in
            if last and valid:
                done_new = done[m] | torch.isin(tok_in, stops)
                buf[m, :, k] = torch.where(done_new, self.eos_token_id,
                                           tok_in)
                n_out[m] += ~done_new
                done[m] = done_new
                if scfg.needs_presence:
                    pres[m][rows, tok_in] = True
                tok_out = sample_token(self._head(y), pres[m], gen, scfg)
            act, tok_carry = self._shift([y, tok_out], ring=True)

        if S > 1:
            group = axis_group(self.mesh, PIPE_AXIS)
            for t in (buf, n_out):
                dist.broadcast(t, dist.get_global_rank(group, S - 1), group)
        return buf, n_out

    # -- public API -------------------------------------------------------

    def generate_from_embeds(self, embeds, position_ids, pos_start,
                             max_new_tokens: int = 200,
                             sampling: Optional[SamplingConfig] = None,
                             seed: int = 0, prompt_ids=None):
        """embeds [M, mb, T, H] (M == n_stages), position_ids [3, M, mb,
        T], pos_start [M] = first decode rope position (T + rope delta)
        per microbatch. Returns (buf [M, mb, max_new], n_out [M, mb]) as
        numpy; row (m, b)'s generation is ``buf[m, b, :n_out[m, b]]``.
        ``prompt_ids`` [M, mb, T]: needed with a repetition penalty (it
        seeds the last stage's presence table)."""
        scfg = sampling or GREEDY
        dev = self.device
        embeds = torch.as_tensor(embeds).to(dev, self.dtype)
        M, mb, T, _ = embeds.shape
        if scfg.needs_presence:
            if prompt_ids is None:
                raise ValueError(
                    "repetition_penalty needs prompt_ids [M, mb, T] to "
                    "seed the presence table")
            pids = torch.as_tensor(np.asarray(prompt_ids)).reshape(
                M, mb, T).to(dev).long()
            pres = torch.zeros((M, mb, self.cfg.vocab_size),
                               dtype=torch.bool, device=dev)
            pres.scatter_(2, pids, True)
        else:
            pres = torch.zeros((M, mb, 1), dtype=torch.bool, device=dev)
        if M != self.n_stages:
            raise ValueError(f"n_micro {M} != n_stages {self.n_stages} — "
                             "the token ring requires M == S")
        if T + max_new_tokens + 1 > self.max_len:
            raise ValueError(f"max_len {self.max_len} < T + max_new + 1 "
                             f"= {T + max_new_tokens + 1} (one scratch row "
                             "is reserved for pipeline bubbles)")
        pos = torch.as_tensor(np.asarray(position_ids)).to(dev).reshape(
            3, M * mb, T)
        cos, sin = mrope_cos_sin(pos, self.cfg.head_dim, self.cfg.rope_theta,
                                 self.cfg.mrope_section)
        cos = cos.reshape(M, mb, T, -1)
        sin = sin.reshape(M, mb, T, -1)
        buf, n_out = self._run(embeds, cos, sin,
                               np.asarray(pos_start).reshape(M), T, pres,
                               seed, max_new_tokens, scfg)
        return buf.cpu().numpy(), n_out.cpu().numpy()

    def generate_text(self, prompt_ids, max_new_tokens: int = 200,
                      sampling: Optional[SamplingConfig] = None,
                      seed: int = 0):
        """Text only: ``prompt_ids`` [M, mb, T] -> M*mb token lists
        (eos-trimmed, microbatch-major)."""
        ids = torch.as_tensor(np.asarray(prompt_ids)).long().to(self.device)
        M, mb, T = ids.shape
        embeds = self.params["embed_tokens"][ids]
        pos3 = torch.arange(T).expand(3, M, mb, T)
        pos_start = np.full((M,), T, np.int64)
        buf, n_out = self.generate_from_embeds(
            embeds, pos3, pos_start, max_new_tokens, sampling, seed,
            prompt_ids=prompt_ids)
        return [buf[m, b, :n_out[m, b]].tolist()
                for m in range(M) for b in range(mb)]
