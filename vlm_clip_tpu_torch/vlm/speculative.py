"""N-gram (prompt-lookup) speculative decoding primitives.

Port of ``vlm_clip_tpu/vlm/speculative.py``. A decode step at serving
batch sizes streams the same quantized weights for T = K+1 positions a
row as for T = 1, so every draft token the model agrees with is nearly
free. The draft source needs no second model: the row's prompt and its
own generated text as one window, the most recent earlier occurrence of
the row's trailing n-gram continued for K tokens (vLLM's prompt-lookup
speculator; the engine seeds the window with the prompt at install).
Without a match the draft repeats the last token.

Exactness (`verify_round`):

- greedy: a draft token is kept iff it equals the model's greedy choice
  given the accepted prefix, so the emitted stream is token-identical to
  plain greedy decode;
- sampled: the draft is a point mass q = delta(d), so speculative
  sampling (Leviathan et al.) becomes: accept d with probability p(d),
  on rejection draw from p with d's mass removed. The emitted marginal
  is p(d)[y = d] + (1 - p(d)) p(y)[y != d] / (1 - p(d)) = p(y), position
  by position. ``p`` is the whole HF-warped distribution (repetition
  penalty with presence evolved over the block, temperature, top-k,
  top-p).

Everything is tensor work on the device: the lookup is a [B, H, n]
window compare and an argmax, the acceptance a prefix product, and the
draws come from a ``torch.Generator`` (so sampled draws differ from the
JAX package's threefry bits; every deterministic part equals it).
Nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vlm_clip_tpu_torch.vlm.sampling import (NEG_INF, SamplingConfig, draw,
                                             warp_logits)


def stop_mask(tokens: torch.Tensor, stops: Sequence[int]) -> torch.Tensor:
    """True where ``tokens`` is one of the stop ids."""
    hit = tokens == int(stops[0])
    for e in stops[1:]:
        hit = hit | (tokens == int(e))
    return hit


def _cap_at_first(a: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """``a`` capped at each row's first True column of ``hit`` [B, K]."""
    first = hit.to(torch.int32).argmax(dim=1)
    return torch.where(hit.any(dim=1), torch.minimum(a, first), a)


def ngram_draft(hist: torch.Tensor, gen_count: torch.Tensor, k: int,
                n: int = 2) -> torch.Tensor:
    """Per-row k-token draft from the row's token window.

    hist [B, H]: the row's window, valid at columns ``< gen_count[b]``
    (later columns hold stale tokens: never a match, and a draft position
    that would read one falls back to the last token). gen_count [B]:
    the valid tokens, including the one the trailing n-gram ends on.

    Returns draft [B, k]: ``hist[j+n : j+n+k]`` for the latest j with
    ``hist[j:j+n] == hist[g-n:g]`` and j + n < g; with no match (or fewer
    than n+1 tokens) the last token repeated.
    """
    B, H = hist.shape
    dev = hist.device
    pos = torch.arange(H, device=dev)
    g = gen_count.to(torch.int64)[:, None]                       # [B, 1]
    tidx = (g - n + torch.arange(n, device=dev)[None]).clamp(0, H - 1)
    tail = hist.gather(1, tidx)                                  # [B, n]
    widx = (pos[:, None] + torch.arange(n, device=dev)[None]).clamp(
        0, H - 1)                                                # [H, n]
    win = hist[:, widx]                                          # [B, H, n]
    match = (win == tail[:, None, :]).all(dim=-1)
    match = match & ((pos[None] + n) < g)   # ends before the trailing n-gram
    found = match.any(dim=-1)
    best = (match * (pos[None] + 1)).argmax(dim=-1)              # latest j
    didx = best[:, None] + n + torch.arange(k, device=dev)[None]
    draft = hist.gather(1, didx.clamp(0, H - 1))
    last = hist.gather(1, (g - 1).clamp(0, H - 1))
    usable = found[:, None] & (g >= n) & (didx < g)
    return torch.where(usable, draft, last)


def accept_greedy(draft: torch.Tensor, preds: torch.Tensor,
                  stops: Sequence[int]) -> torch.Tensor:
    """Longest accepted prefix under greedy verification, [B] in [0, K].

    draft [B, K]; preds [B, K+1], ``preds[:, i]`` the model's greedy token
    after consuming (x0, draft[:, :i]). A stop token among the
    predictions caps the acceptance at its position (the stop is then
    the carried token, ``preds[:, a]``).
    """
    K = draft.shape[1]
    ok = draft == preds[:, :K]
    a = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    return _cap_at_first(a, stop_mask(preds[:, :K], stops))


def verify_round(draft: torch.Tensor, logits: torch.Tensor,
                 x0: torch.Tensor, presence: torch.Tensor,
                 generator: Optional[torch.Generator],
                 scfg: SamplingConfig, stops: Sequence[int]):
    """One lossless verification round, greedy or sampled.

    draft [B, K]; logits [B, K+1, V] fp32, position i the distribution
    after consuming (x0, draft[:, :i]); x0 [B] the carried token recorded
    this round (it enters the presence set before position 0); presence
    [B, V] (or [B, 1] when the config needs none) not yet including x0;
    ``generator`` is drawn from only when sampling.

    Returns ``(a [B], cand [B, K+1])``: the chain emits ``draft[:, :m]``
    (m = a, possibly capped by the caller's budget) and carries
    ``cand[:, m]``. ``a`` is capped at the first accepted stop;
    ``cand[:, j]`` for j < K is the model's correction where position j
    rejected (greedy: its argmax; sampled: a draw from p_j without
    draft_j's mass) or draft_j where it accepted; ``cand[:, K]`` the
    continuation after a full accept.
    """
    B, K = draft.shape
    rows = torch.arange(B, device=draft.device)

    if not scfg.needs_presence and not scfg.do_sample:
        preds = logits.argmax(dim=-1)
        return accept_greedy(draft, preds, stops), preds

    if scfg.needs_presence:
        # the distribution at position i follows x0 and draft[:, :i]
        pres = presence.clone()
        pres[rows, x0] = True
        warps = []
        for i in range(K + 1):
            warps.append(warp_logits(logits[:, i], pres, scfg))
            if i < K:
                pres[rows, draft[:, i]] = True
        warped = torch.stack(warps, dim=1)                   # [B, K+1, V]
    else:
        warped = warp_logits(logits, presence[:, :, None], scfg)

    if not scfg.do_sample:
        preds = warped.argmax(dim=-1)
        return accept_greedy(draft, preds, stops), preds

    probs = torch.softmax(warped[:, :K], dim=-1)
    pd = probs.gather(-1, draft[..., None])[..., 0]           # p_i(d_i)
    u = torch.rand((B, K), generator=generator, device=draft.device)
    acc = u < pd      # a point-mass q: accept with probability p(d)
    a = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    a = _cap_at_first(a, stop_mask(draft, stops))  # an accepted stop ends

    # the residual: p without the draft's mass (a row with p(d) = 1 is
    # drawn from with probability 0; whatever index it gives is unused)
    res = warped[:, :K].scatter(-1, draft[..., None], NEG_INF)
    cand = draw(torch.softmax(torch.cat([res, warped[:, K:]], dim=1),
                              dim=-1), generator)
    cand = torch.cat([torch.where(acc, draft, cand[:, :K]), cand[:, K:]],
                     dim=1)
    return a, cand
