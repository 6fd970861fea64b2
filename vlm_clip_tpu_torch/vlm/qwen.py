"""Qwen2.5-VL generation: tokenizer, batched generator, context extractor.

Port of ``vlm_clip_tpu/vlm/qwen.py``, the reference's
``VLMContextExtractor`` (model_v.py:43-142): describe a face image with
Qwen2.5-VL, embed the description with CLIP. A generation runs the vision
tower, the embed scatter and the prefill, then a Python decode loop over
one preallocated KV cache (written in place), with HF-parity sampling
(``vlm/sampling.py``). The loop reads ``done.all()`` on the host once a
step to skip the forward when every row has stopped.

While tracing is on (``utils/profiling``), ``generate_batch`` records the
span ``qwen.generate_batch`` and, inside it, ``qwen.prepare`` (vision
inputs and prompt ids), ``qwen.prefill`` (``prefill_batch``), one
``qwen.stop_check`` (the ``done.all()`` read, where the host waits on the
device) and one ``qwen.decode_step`` (a forward and its sampling) a
step, and ``qwen.readback``; it counts ``qwen.prefill_rows`` and
``qwen.decode_forwards``.

On a CUDA device with an unsharded text tree, a whole batch's decode
forward is one CUDA graph (:class:`_DecodeGraph`) over a cache the
generator keeps for its batch size, captured at the first decode step
(inside the span ``qwen.graph_capture``) and replayed at every later
one: the counters ``qwen.decode_graph_captures`` and
``qwen.decode_graph_replays``. Sampling and the stop check stay eager.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vlm_clip_tpu_torch.ops import decode_attention, quant
from vlm_clip_tpu_torch.parallel import tensor_parallel as TP
from vlm_clip_tpu_torch.utils.profiling import annotate, count
from vlm_clip_tpu_torch.vlm.extractor import VLM_PROMPT, ClipTextEncoderMixin
from vlm_clip_tpu_torch.vlm.qwen_model import (KVCache, QwenVLConfig,
                                               cache_kv_heads, init_kv_cache,
                                               split_route, text_forward,
                                               vision_forward)
from vlm_clip_tpu_torch.vlm.qwen_process import (VisionInputs,
                                                 build_prompt_ids,
                                                 prepare_vision_inputs,
                                                 rope_index_single)
from vlm_clip_tpu_torch.vlm.sampling import (GREEDY, SamplingConfig,
                                             load_generation_config,
                                             sample_token)

_NEG = float(torch.finfo(torch.float32).min)  # additive-mask -inf
# GPT-2-family pretokenizer (re-module approximation of Qwen's \p classes)
_QWEN_PAT = re.compile(
    r"'(?:[sdmt]|ll|ve|re)| ?[^\W\d_]+| ?\d{1,3}| ?[^\s\w]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+",
    re.IGNORECASE,
)


class QwenBPETokenizer:
    """Byte-level BPE from an HF ``tokenizer.json`` (Qwen2 family); a copy
    of the JAX package's."""

    def __init__(self, tokenizer_json: str):
        from vlm_clip_tpu_torch.data.tokenizer import bytes_to_unicode

        with open(tokenizer_json, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        self.encoder: Dict[str, int] = model["vocab"]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self.special: Dict[str, int] = {
            t["content"]: t["id"] for t in data.get("added_tokens", [])}
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.decoder.update({v: k for k, v in self.special.items()})
        self._cache: Dict[str, List[str]] = {}
        self._special_pat = re.compile(
            "(" + "|".join(re.escape(s) for s in sorted(
                self.special, key=len, reverse=True)) + ")") \
            if self.special else None

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 31))
            if bigram not in self.bpe_ranks:
                break
            a, b = bigram
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        res = list(word)
        self._cache[token] = res
        return res

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        chunks = self._special_pat.split(text) if self._special_pat \
            else [text]
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self.special:
                ids.append(self.special[chunk])
                continue
            for tok in _QWEN_PAT.findall(chunk):
                mapped = "".join(self.byte_encoder[b]
                                 for b in tok.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids, skip_special: bool = True) -> str:
        parts: List[str] = []
        for i in ids:
            tok = self.decoder.get(int(i), "")
            if skip_special and tok in self.special:
                continue
            parts.append(tok)
        text = "".join(parts)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace")


def _sharded(tree) -> bool:
    """Whether a tree holds a tensor-parallel leaf (``TP.TPLinear``)."""
    if isinstance(tree, TP.TPLinear):
        return True
    return isinstance(tree, dict) and any(_sharded(v) for v in tree.values())


class _DecodeGraph:
    """One decode forward as a CUDA graph over a cache it keeps: the token
    embedding gather, ``text_forward`` at the canonical decode mask with a
    per-row [B] depth, and the head's fp32 logits. On a split-route cache
    (``qwen_model.split_route``) the per-row route is the eager step's
    arithmetic at its int depth, bit for bit.

    The inputs are device buffers, set before each replay: ``tokens``
    [B], the rope position ``pos`` [3, 1, 1] and ``depth`` [B]. The first
    :meth:`run` runs the forward eagerly on a side stream (which loads
    the kernels and sizes their workspaces) and captures it there; every
    later one replays it and returns a copy of its logits. K7, K8 and
    the int8 GEMM launch on the current stream, so the capture records
    them as it does torch's kernels; K8's workspace is reserved before the
    capture and held here. A replay runs none of the op modules' Python,
    so their launch counters (``ops/quant``, ``ops/decode_attention``) are
    credited on each replay with the launches the capture recorded.
    """

    def __init__(self, text_params, cfg, dtype, impl: str, cache: KVCache):
        B, dev = cache.k.shape[1], cache.k.device
        self.params, self.cfg, self.dtype, self.impl = (text_params, cfg,
                                                        dtype, impl)
        self.cache = cache
        self.tokens = torch.zeros(B, dtype=torch.long, device=dev)
        self.pos = torch.zeros((3, 1, 1), dtype=torch.long, device=dev)
        self.depth = torch.zeros(B, dtype=torch.int32, device=dev)
        self.graph = None
        self.logits = None      # the graph's output
        self.workspace = None   # K8's, at the captured shapes
        self.launches = []      # (kernel function, launches a replay)

    def reset(self) -> KVCache:
        """The cache, emptied as a new one is, for a new batch."""
        c = self.cache
        c.k.zero_()
        c.v.zero_()
        if c.k_scale is not None:
            c.k_scale.fill_(1.0)
            c.v_scale.fill_(1.0)
        return dataclasses.replace(c, length=0)

    def forward(self) -> torch.Tensor:
        """The step the graph holds, run eagerly: fp32 logits [B, V]."""
        emb = self.params["embed_tokens"][self.tokens][:, None]
        logits, _ = text_forward(self.params, emb.to(self.dtype), self.pos,
                                 self.cfg, None, self.cache, self.depth,
                                 impl=self.impl)
        return logits[:, -1]

    def run(self, tokens, pos: int, length: int) -> torch.Tensor:
        """The step for ``tokens`` at rope position ``pos``, written at
        cache row ``length``: fp32 logits [B, V]."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.depth.fill_(length)
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        for kernel, n in self.launches:
            kernel.launches += n
        count("qwen.decode_graph_replays")
        return self.logits.clone()

    def _capture(self) -> torch.Tensor:
        kernels = [getattr(m, name) for m in (quant, decode_attention)
                   for name in m.launch_counts()]
        dev = self.tokens.device
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        with annotate("qwen.graph_capture"):
            k8 = decode_attention.decode_attention_kernel.launches
            side.wait_stream(main)
            with torch.cuda.stream(side):
                logits = self.forward()  # this step's, eagerly
            main.wait_stream(side)
            logits.record_stream(main)
            if decode_attention.decode_attention_kernel.launches > k8:
                # K8 is on this step's route: its workspace, now sized
                _, B, S, kv, d = self.cache.k.shape
                self.workspace = decode_attention.reserve_workspace(
                    dev, B, 1, self.cfg.num_heads, kv, d, S)
            before = [k.launches for k in kernels]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.logits = self.forward()
            # the capture ran no kernel: its launches count at each replay
            self.launches = [(k, k.launches - n)
                             for k, n in zip(kernels, before)]
            for k, n in zip(kernels, before):
                k.launches = n
            self.graph = graph
        count("qwen.decode_graph_captures")
        return logits


class QwenVLGenerator:
    """Batched generation over the port's Qwen2.5-VL on the device its
    params live on.

    KV-cache contract: prefill writes rows ``0..T-1``; the decode step for
    the token at sequence position ``T+s`` writes row ``T+s`` and attends
    columns ``<= T+s``. Over a tensor-parallel rank's tree
    (``parallel/sharding.shard_params``) the cache holds this rank's kv
    heads and every rank samples the same token from the gathered
    logits. ``impl="torch"`` runs K7 and K8's plain versions
    wherever the kernels would launch (the plain route of a check).

    On a CUDA device with an unsharded text tree and a split-route cache,
    :meth:`prefill_batch` writes into one cache the generator keeps for
    its batch size (a later batch overwrites the cache an earlier one
    returned), and the decode steps over it replay one CUDA graph
    (:class:`_DecodeGraph`), captured once at the first step; a new
    batch size drops the graph and its cache. Every other generator (on
    the CPU, over a tensor-parallel rank's tree, with a small cache) and
    every other cache decodes eagerly.
    """

    def __init__(self, params: Dict, cfg: QwenVLConfig,
                 max_len: int = 1536, dtype=None, kv_bits: int = 16,
                 impl: str = "auto"):
        if kv_bits not in (8, 16):
            raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.dtype = dtype or torch.bfloat16
        self.kv_quantized = kv_bits == 8
        self.impl = impl
        self.device = params["text"]["embed_tokens"].device
        # set True (with a normalization-folded patch embed) to have
        # generate()/generate_batch() ship raw uint8 patches
        self.u8_patches = False
        self._decode_graph: Optional[_DecodeGraph] = None

    # -- device steps -------------------------------------------------------

    def _new_cache(self, n_rows: int):
        """A cache at this rank's kv heads (all of them unsharded)."""
        return init_kv_cache(self.cfg.text, n_rows, self.max_len, self.dtype,
                             self.kv_quantized, device=self.device,
                             kv_heads=cache_kv_heads(self.params["text"],
                                                     self.cfg.text))

    def _batch_cache(self, n_rows: int):
        """A whole batch's cache: where decode steps run as a graph, the
        graph's own, emptied (see the class docstring)."""
        dg = self._decode_graph
        if dg is not None and dg.cache.k.shape[1] == n_rows:
            return dg.reset()
        self._decode_graph = None
        cache = self._new_cache(n_rows)
        if self.device.type == "cuda" and not _sharded(self.params["text"]) \
                and split_route(cache.k[0]):
            self._decode_graph = _DecodeGraph(self.params["text"],
                                              self.cfg.text, self.dtype,
                                              self.impl, cache)
        return cache

    def _graph_for(self, cache) -> Optional[_DecodeGraph]:
        """The decode graph over ``cache``, if it is the graph's."""
        dg = self._decode_graph
        return dg if dg is not None and cache.k is dg.cache.k else None

    @torch.no_grad()
    def _prefill(self, embeds, position_ids, cache, t_last: int):
        """Prompt rows into ``cache``; next-token fp32 logits at ``t_last``
        (the last real position of a tail-padded prompt)."""
        T = embeds.shape[1]
        S = cache.k.shape[2]
        cols = torch.arange(S, device=self.device)
        allowed = cols[None, :] <= torch.arange(T, device=self.device)[:, None]
        mask = torch.where(allowed, 0.0, _NEG)[None, None]
        logits, cache = text_forward(self.params["text"], embeds,
                                     position_ids, self.cfg.text, mask,
                                     cache, 0, last_index=t_last,
                                     impl=self.impl)
        return logits[:, -1], cache

    @torch.no_grad()
    def _embed_prefill(self, patches, rope, wmask, fmask, rev, ids,
                       img_slots, pos3, cache, t_last: int, uw=None):
        """Vision tower, embed scatter and prefill. patches [B, S, D]."""
        B = patches.shape[0]
        vis = vision_forward(self.params["vision"], patches.to(self.dtype),
                             rope, wmask, fmask, self.cfg.vision,
                             uniform_window=uw, impl=self.impl)
        vis = vis[:, rev]                                  # [B, n_vis, H]
        embeds = self.params["text"]["embed_tokens"][ids]  # [T, H]
        embeds = embeds[None].expand(B, *embeds.shape).clone()
        embeds[:, img_slots] = vis.to(embeds.dtype)
        return self._prefill(embeds.to(self.dtype), pos3, cache, t_last)

    @torch.no_grad()
    def _decode_step(self, tokens, pos: int, cache, length: int):
        """tokens [B] at rope position ``pos``, written at cache row
        ``length``; the canonical decode mask (``mask=None``). Over the
        decode graph's cache, the graph's step."""
        dg = self._graph_for(cache)
        if dg is not None:
            return (dg.run(tokens, pos, length),
                    dataclasses.replace(cache, length=cache.length + 1))
        emb = self.params["text"]["embed_tokens"][tokens][:, None]
        position_ids = torch.full((3, 1, 1), pos, device=self.device)
        logits, cache = text_forward(self.params["text"], emb.to(self.dtype),
                                     position_ids, self.cfg.text, None,
                                     cache, length, impl=self.impl)
        return logits[:, -1], cache

    @torch.no_grad()
    def _decode_loop(self, logits0, pos_start: int, cache, length0: int,
                     presence, generator, max_new: int,
                     scfg: SamplingConfig):
        """Generation after prefill: (buf [B, max_new], n_out [B], cache).
        Row b's tokens are buf[b, :n_out[b]], eos excluded; buf holds eos
        after a row stops; the forward is skipped once every row is done
        or the budget is spent."""
        B = logits0.shape[0]
        eos = self.cfg.eos_token_id
        stops = torch.tensor((eos,) + tuple(scfg.extra_eos),
                             device=self.device)
        tokens = sample_token(logits0, presence, generator, scfg)
        buf = torch.full((B, max_new), eos, dtype=torch.long,
                         device=self.device)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        n_out = torch.zeros(B, dtype=torch.long, device=self.device)
        rows = torch.arange(B, device=self.device)
        for step in range(max_new):
            done = done | torch.isin(tokens, stops)
            buf[:, step] = torch.where(done, eos, tokens)
            n_out += ~done
            if scfg.needs_presence:
                presence[rows, tokens] = True
            if step + 1 >= max_new:
                break
            with annotate("qwen.stop_check"):
                stop = bool(done.all())
            if stop:
                break
            with annotate("qwen.decode_step"):
                logits, cache = self._decode_step(tokens, pos_start + step,
                                                  cache, length0 + step)
                tokens = sample_token(logits, presence, generator, scfg)
            count("qwen.decode_forwards")
        return buf, n_out, cache

    def _merge_cache(self, big, sub, offset: int):
        """Write a prefill chunk's KV rows (and scales) into the
        full-batch cache at batch ``offset``, in place."""
        n = sub.k.shape[1]
        for name in ("k", "v", "k_scale", "v_scale"):
            dst = getattr(big, name)
            if dst is not None:
                dst[:, offset:offset + n] = getattr(sub, name)
        return big

    # -- host glue ----------------------------------------------------------

    def _mask_args(self, vision: VisionInputs):
        """The vision tower's masks: none on the uniform-window path."""
        if vision.uniform_window is not None:
            return None, None
        return (torch.from_numpy(vision.window_mask).to(self.device),
                torch.from_numpy(vision.full_mask).to(self.device))

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(self.device)

    @torch.no_grad()
    def embed_sequence(self, ids: np.ndarray, vision: VisionInputs):
        """[1, T, H] text embeds with the vision embeds over the image-pad
        slots."""
        wmask, fmask = self._mask_args(vision)
        vis = vision_forward(self.params["vision"],
                             self._t(vision.patches).to(self.dtype),
                             self._t(vision.rot_pos_emb), wmask, fmask,
                             self.cfg.vision,
                             uniform_window=vision.uniform_window,
                             impl=self.impl)
        vis = vis[self._t(vision.reverse_index)]
        embeds = self.params["text"]["embed_tokens"][self._t(ids)].clone()
        img_slots = np.nonzero(ids == self.cfg.image_token_id)[0]
        embeds[self._t(img_slots)] = vis.to(embeds.dtype)
        return embeds[None].to(self.dtype)

    def _run_decode_loop(self, logits, cache, T: int, delta: int,
                         max_new_tokens: int,
                         sampling: Optional[SamplingConfig],
                         seed: int, prompt_ids) -> List[List[int]]:
        if T + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({T} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds the KV cache max_len "
                f"({self.max_len}); raise QwenVLGenerator(max_len=...) "
                f"or shorten the generation")
        scfg = sampling or GREEDY
        B = logits.shape[0]
        if scfg.needs_presence:
            presence = torch.zeros(B, self.cfg.text.vocab_size,
                                   dtype=torch.bool, device=self.device)
            presence[:, self._t(np.unique(prompt_ids))] = True
        else:
            presence = torch.zeros(B, 1, dtype=torch.bool,
                                   device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        buf, n_out, _ = self._decode_loop(logits, T + delta, cache, T,
                                          presence, gen, max_new_tokens,
                                          scfg)
        with annotate("qwen.readback"):
            buf, n_out = buf.cpu().numpy(), n_out.cpu().numpy()
            return [buf[b, :n_out[b]].tolist() for b in range(B)]

    def generate(self, image, prompt_text: str, tokenizer,
                 max_new_tokens: int = 200,
                 fixed_resolution: Optional[int] = 448,
                 sampling: Optional[SamplingConfig] = None,
                 seed: int = 0,
                 resolution_buckets=None,
                 pad_to_ladder=None,
                 min_pixels: Optional[int] = None,
                 max_pixels: Optional[int] = None) -> List[int]:
        """One image: ``pad_to_ladder`` (with ``fixed_resolution=None``)
        keeps the exact HF smart_resize grid with the patch sequence
        tail-padded to a ladder rung and the prompt to a multiple of 64."""
        budget = {}
        if min_pixels is not None:
            budget["min_pixels"] = min_pixels
        if max_pixels is not None:
            budget["max_pixels"] = max_pixels
        vision = prepare_vision_inputs(image, self.cfg.vision,
                                       fixed_resolution=fixed_resolution,
                                       resolution_buckets=resolution_buckets,
                                       raw_uint8=self.u8_patches,
                                       pad_to_ladder=pad_to_ladder,
                                       **budget)
        ids = build_prompt_ids(tokenizer, prompt_text,
                               vision.num_vision_tokens, self.cfg)
        pad_text_to = -(-len(ids) // 64) * 64 \
            if pad_to_ladder is not None else None
        return self.generate_from_ids(ids, vision, max_new_tokens,
                                      sampling=sampling, seed=seed,
                                      pad_text_to=pad_text_to)

    def generate_batch(self, images, prompt_text: str, tokenizer,
                       max_new_tokens: int = 200,
                       fixed_resolution: Optional[int] = 448,
                       sampling: Optional[SamplingConfig] = None,
                       seed: int = 0,
                       prefill_chunk: Optional[int] = None
                       ) -> List[List[int]]:
        """Batched decode over several images with one shared prompt (one
        fixed resolution, so every row shares the sequence layout)."""
        with annotate("qwen.generate_batch"):
            with annotate("qwen.prepare"):
                visions = [prepare_vision_inputs(
                    img, self.cfg.vision, fixed_resolution=fixed_resolution,
                    raw_uint8=self.u8_patches) for img in images]
                ids = build_prompt_ids(tokenizer, prompt_text,
                                       visions[0].num_vision_tokens,
                                       self.cfg)
            return self.generate_batch_from_ids(
                ids, visions, max_new_tokens, sampling=sampling, seed=seed,
                prefill_chunk=prefill_chunk)

    def generate_batch_from_ids(self, ids: np.ndarray,
                                visions: List[VisionInputs],
                                max_new_tokens: int = 200,
                                sampling: Optional[SamplingConfig] = None,
                                seed: int = 0,
                                prefill_chunk: Optional[int] = None,
                                pad_text_to: Optional[int] = None
                                ) -> List[List[int]]:
        """``prefill_chunk``: run the vision tower and prefill in
        sub-batches of this many rows, each merged into one full-batch
        cache for one decode loop (same tokens, capped activation memory).
        ``pad_text_to``: tail-pad the shared prompt to this length."""
        logits, cache, T, delta = self.prefill_batch(
            ids, visions, prefill_chunk=prefill_chunk,
            pad_text_to=pad_text_to)
        return self._run_decode_loop(logits, cache, T, delta,
                                     max_new_tokens, sampling, seed, ids)

    def prefill_batch(self, ids: np.ndarray, visions: List[VisionInputs],
                      prefill_chunk: Optional[int] = None,
                      pad_text_to: Optional[int] = None):
        """The vision tower, embed scatter and prefill of
        :meth:`generate_batch_from_ids`: (next-token fp32 logits [B, V],
        the filled cache, prompt length T, rope delta)."""
        B = len(visions)
        v0 = visions[0]
        for i, v in enumerate(visions[1:], 1):
            if v.grid != v0.grid or v.patches.shape != v0.patches.shape:
                raise ValueError(
                    f"generate_batch requires one shared sequence layout; "
                    f"vision input {i} has grid {v.grid} vs {v0.grid} — "
                    f"pass fixed_resolution (or bucket by grid) for "
                    f"mixed-resolution batches")
        count("qwen.prefill_rows", B)
        with annotate("qwen.prefill"):
            pos, delta = rope_index_single(ids, v0.grid, self.cfg)
            patches = np.stack([v.patches for v in visions])
            wmask, fmask = self._mask_args(v0)
            T = len(ids)
            img_slots = np.nonzero(ids == self.cfg.image_token_id)[0]
            rev_np, img_slots = self._pad_slots(v0, img_slots)
            ids_p, pos_p = (self._pad_text(ids, np.asarray(pos), pad_text_to)
                            if pad_text_to else (ids, np.asarray(pos)))
            if len(ids_p) > self.max_len:
                raise ValueError(
                    f"padded prompt ({len(ids_p)} tokens) exceeds the KV "
                    f"cache max_len ({self.max_len})")
            T_p = len(ids_p)
            rev, jids, jslots = (self._t(a)
                                 for a in (rev_np, ids_p, img_slots))
            rope = self._t(v0.rot_pos_emb)

            def run_prefill(chunk_patches, n_rows, cache):
                pos3 = self._t(np.broadcast_to(pos_p[:, None, :],
                                               (3, n_rows, T_p)))
                return self._embed_prefill(
                    self._t(chunk_patches), rope, wmask, fmask, rev, jids,
                    jslots, pos3, cache, T - 1, uw=v0.uniform_window)

            cache = self._batch_cache(B)
            if prefill_chunk is None or prefill_chunk >= B:
                logits, cache = run_prefill(patches, B, cache)
            else:
                logit_parts = []
                for off in range(0, B, prefill_chunk):
                    sub = patches[off:off + prefill_chunk]
                    logits_c, sub_cache = run_prefill(
                        sub, len(sub), self._new_cache(len(sub)))
                    cache = self._merge_cache(cache, sub_cache, off)
                    logit_parts.append(logits_c)
                cache.length += T
                logits = torch.cat(logit_parts, dim=0)
            return logits, cache, T, delta

    @staticmethod
    def _pad_slots(vision: VisionInputs, img_slots: np.ndarray):
        """Fixed-shape (rev, img_slots) for a tail-padded patch sequence:
        both padded with their last entry (duplicate writes carry the
        same value)."""
        n_cap = len(vision.patches) * len(vision.reverse_index) \
            // max(1, (vision.valid_len or len(vision.patches)))
        rev = vision.reverse_index
        if len(rev) < n_cap:
            rev = np.concatenate(
                [rev, np.full(n_cap - len(rev), rev[-1], rev.dtype)])
            img_slots = np.concatenate(
                [img_slots, np.full(n_cap - len(img_slots),
                                    img_slots[-1], img_slots.dtype)])
        return rev, img_slots

    @staticmethod
    def _pad_text(ids: np.ndarray, pos: np.ndarray, pad_text_to: int):
        """Tail-pad prompt ids/positions; pad positions continue the
        arange (causally invisible, overwritten by the decode loop)."""
        T = len(ids)
        if pad_text_to < T:
            raise ValueError(f"pad_text_to={pad_text_to} < prompt "
                             f"length {T}")
        pad = pad_text_to - T
        if pad == 0:
            return ids, pos
        ids_p = np.concatenate([ids, np.full(pad, 0, ids.dtype)])
        pos_p = np.concatenate(
            [pos, pos[:, -1:] + 1 + np.arange(pad)[None]], axis=1)
        return ids_p, pos_p

    def generate_from_ids(self, ids: np.ndarray, vision: VisionInputs,
                          max_new_tokens: int = 200,
                          sampling: Optional[SamplingConfig] = None,
                          seed: int = 0,
                          pad_text_to: Optional[int] = None) -> List[int]:
        return self.generate_batch_from_ids(
            ids, [vision], max_new_tokens, sampling=sampling, seed=seed,
            pad_text_to=pad_text_to)[0]


class QwenVLContextExtractor(ClipTextEncoderMixin):
    """The reference VLMContextExtractor contract on the port's Qwen.

    Needs a local weights directory (safetensors shards, tokenizer.json,
    optionally generation_config.json) and raises at construction without
    one: use StubContextExtractor or CachedContextExtractor then.
    ``quant_bits``: a :func:`quantize_preset` preset, 8 by default.
    """

    def __init__(self, clip_params, clip_cfg, clip_tokenizer,
                 weights_path: Optional[str] = None,
                 quant_bits=8, policy=None,
                 max_new_tokens: int = 200,
                 fixed_resolution: Optional[int] = 448,
                 sampling: Optional[SamplingConfig] = None,
                 seed: int = 0,
                 max_len: int = 768,
                 pad_to_ladder=None,
                 prefill_chunk: Optional[int] = None,
                 min_pixels: Optional[int] = None,
                 max_pixels: Optional[int] = None,
                 kv_bits: int = 16,
                 device="cuda"):
        super().__init__(clip_params, clip_cfg, clip_tokenizer, policy)
        if not weights_path or not os.path.isdir(weights_path):
            raise FileNotFoundError(
                "Qwen2.5-VL weights not found (expected a directory with "
                "safetensors + tokenizer.json); pass weights_path or use "
                "the stub/cache context backends")
        from vlm_clip_tpu_torch.vlm.qwen_convert import (
            convert_qwen_vl, fold_qwen_patch_normalization)
        from vlm_clip_tpu_torch.vlm.qwen_model import qwen25vl_3b

        sd = load_safetensors_dir(weights_path)
        self.qwen_cfg = qwen25vl_3b()
        params = convert_qwen_vl(sd, self.qwen_cfg, device=device)
        del sd
        # raw uint8 patches: the normalization folds into the patch embed
        params["vision"] = fold_qwen_patch_normalization(
            params["vision"], self.qwen_cfg.vision)
        params, self.qwen_cfg = quantize_preset(params, self.qwen_cfg,
                                                quant_bits)
        self.generator = QwenVLGenerator(params, self.qwen_cfg,
                                         max_len=max_len, kv_bits=kv_bits)
        self.generator.u8_patches = True
        self.qwen_tokenizer = QwenBPETokenizer(
            os.path.join(weights_path, "tokenizer.json"))
        self.max_new_tokens = max_new_tokens
        self.fixed_resolution = fixed_resolution
        self.pad_to_ladder = pad_to_ladder
        self.prefill_chunk = prefill_chunk
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        # like HF generate(): defaults from generation_config.json
        self.sampling = sampling if sampling is not None else \
            load_generation_config(weights_path, self.qwen_cfg.eos_token_id)
        self.seed = seed
        self._n_generated = 0

    def _pixel_budget(self) -> Dict[str, int]:
        budget = {}
        if self.min_pixels is not None:
            budget["min_pixels"] = self.min_pixels
        if self.max_pixels is not None:
            budget["max_pixels"] = self.max_pixels
        return budget

    def extract_context_from_image(self, image) -> Optional[str]:
        try:
            self._n_generated += 1  # a distinct sampling seed per image
            ids = self.generator.generate(
                image, VLM_PROMPT, self.qwen_tokenizer,
                max_new_tokens=self.max_new_tokens,
                fixed_resolution=self.fixed_resolution,
                sampling=self.sampling,
                seed=self.seed + self._n_generated,
                pad_to_ladder=self.pad_to_ladder,
                **self._pixel_budget())
            text = self.qwen_tokenizer.decode(ids).strip()
            return text if text else None
        except Exception as e:  # None-on-error (model_v.py:124-126)
            print(f"Error processing image for VLM context: {e}")
            return None

    def extract_contexts_batch(self, images) -> List[Optional[str]]:
        """One decode loop per batch (shared prompt layout); a failed
        batch falls back to per-image extraction. With
        ``fixed_resolution=None`` images are grouped by grid when a patch
        ladder is set, else extracted one by one."""
        if self.fixed_resolution is None:
            if self.pad_to_ladder is None:
                return [self.extract_context_from_image(im)
                        for im in images]
            return self._extract_batch_dynamic(list(images))
        try:
            self._n_generated += 1
            id_lists = self.generator.generate_batch(
                list(images), VLM_PROMPT, self.qwen_tokenizer,
                max_new_tokens=self.max_new_tokens,
                fixed_resolution=self.fixed_resolution,
                sampling=self.sampling,
                seed=self.seed + self._n_generated,
                prefill_chunk=self.prefill_chunk)
            return [self._decode_or_none(ids) for ids in id_lists]
        except Exception as e:
            print(f"Batched VLM context extraction failed ({e}); "
                  f"falling back to per-image")
            return [self.extract_context_from_image(im) for im in images]

    def _decode_or_none(self, ids) -> Optional[str]:
        text = self.qwen_tokenizer.decode(ids).strip()
        return text if text else None

    def _extract_batch_dynamic(self, images) -> List[Optional[str]]:
        """Exact-HF-resolution batching: group by smart_resize grid."""
        vins: List[Optional[VisionInputs]] = []
        for im in images:
            try:
                vins.append(prepare_vision_inputs(
                    im, self.qwen_cfg.vision, fixed_resolution=None,
                    raw_uint8=self.generator.u8_patches,
                    pad_to_ladder=self.pad_to_ladder,
                    **self._pixel_budget()))
            except Exception as e:
                print(f"Error processing image for VLM context: {e}")
                vins.append(None)
        groups: Dict[tuple, List[int]] = {}
        for i, v in enumerate(vins):
            if v is not None:
                groups.setdefault(
                    (v.grid, v.patches.shape[0]), []).append(i)
        out: List[Optional[str]] = [None] * len(images)
        for (grid, _), idxs in groups.items():
            gvins = [vins[i] for i in idxs]
            ids = build_prompt_ids(self.qwen_tokenizer, VLM_PROMPT,
                                   gvins[0].num_vision_tokens, self.qwen_cfg)
            try:
                self._n_generated += 1
                id_lists = self.generator.generate_batch_from_ids(
                    ids, gvins, max_new_tokens=self.max_new_tokens,
                    sampling=self.sampling,
                    seed=self.seed + self._n_generated,
                    prefill_chunk=self.prefill_chunk,
                    pad_text_to=-(-len(ids) // 64) * 64)
                for i, toks in zip(idxs, id_lists):
                    out[i] = self._decode_or_none(toks)
            except Exception as e:
                print(f"Batched VLM context extraction failed for grid "
                      f"{grid} ({e}); falling back to per-image")
                for i in idxs:
                    out[i] = self.extract_context_from_image(images[i])
        return out


def quantize_preset(params: Dict[str, Any], cfg: QwenVLConfig, quant_bits
                    ) -> Tuple[Dict[str, Any], QwenVLConfig]:
    """(params, cfg) under a weight-only preset, decode layouts fused:
    8 or 4 (every linear), ``"nf4"`` (every linear NF4, the head tied),
    ``"8h4"`` (int8 layers, int4 untied head) or ``"mixed"`` (int4 text
    gate/up too); the two head presets untie the head in cfg. A falsy
    ``quant_bits`` keeps the weights fp."""
    import dataclasses

    from vlm_clip_tpu_torch.vlm.qwen_convert import (MIXED_DECODE_BITS,
                                                     quantize_qwen_params)

    if quant_bits in ("mixed", "8h4"):
        layer_bits = MIXED_DECODE_BITS if quant_bits == "mixed" else 8
        params = quantize_qwen_params(params, layer_bits, head_bits=4,
                                      fuse_decode=True)
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, tie_word_embeddings=False))
    elif quant_bits:
        params = quantize_qwen_params(params, quant_bits, fuse_decode=True)
    return params, cfg


def load_safetensors_dir(path: str) -> Dict[str, Any]:
    """All tensors from every .safetensors shard in a directory, read by
    the port's own reader (``convert/safetensors_io.py``: numpy arrays,
    BF16 entries as torch tensors)."""
    from vlm_clip_tpu_torch.convert.safetensors_io import load_file

    out: Dict[str, Any] = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            out.update(load_file(os.path.join(path, fname)))
    if not out:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return out
