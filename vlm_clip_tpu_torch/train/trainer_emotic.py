"""EMOTIC multi-label training: adapter + VAD head over frozen CLIP (port
of ``vlm_clip_tpu/train/trainer_emotic.py``).

The reference ships EMOTIC loaders and the .mat converter but its
training harness is external; the parity gate is "EMOTIC eval mAP"
(BASELINE.json). Label contract: 26-category one-hot + continuous VAD /
10.

Encode-once, as pipeline T: the frozen tower runs ONCE over the dataset,
then every epoch is adapter math — a T-style visual adapter alpha-blended
onto the pooled features (``adapt_features``: kernel K6 forward and
backward on a card) scores the 26 category-text embeddings (sigmoid BCE)
and a small linear head regresses VAD (L2, weighted). The trained head
plugs into ``eval/emotic.evaluate_emotic(adapter_params=...)``, and its
npz file is the reference's, so heads cross between the two packages.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.models import adapters as A
from vlm_clip_tpu_torch.models import layers as L
from vlm_clip_tpu_torch.train.optim import Optimizer, adam

log = logging.getLogger(__name__)


def init_emotic_head(gen: torch.Generator, feat_dim: int,
                     bottleneck: int = 192, with_vad: bool = True,
                     device="cuda") -> Dict:
    """{'visual': feature adapter, 'vad': {'kernel','bias'}?}, drawn from
    ``gen`` with the reference's shapes and scales."""
    params = {"visual": A.init_feature_adapter(gen, feat_dim, bottleneck,
                                               device)}
    if with_vad:
        params["vad"] = {
            "kernel": torch.randn(feat_dim, 3, generator=gen, device=device)
            * feat_dim ** -0.5,
            "bias": torch.full((3,), 0.5, device=device),  # VAD/10 midpoint
        }
    return params


def emotic_forward(params: Dict, feats_norm: torch.Tensor,
                   category_emb: torch.Tensor, alpha: float, scale: float,
                   impl: str = "auto"
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(category logits [B, 26], vad prediction [B, 3] or None)."""
    adapted = A.adapt_features(params["visual"], feats_norm, alpha,
                               impl=impl)
    logits = scale * (adapted.float() @ category_emb.T)
    vad = None
    if "vad" in params:
        vad = adapted.float() @ params["vad"]["kernel"] \
            + params["vad"]["bias"]
    return logits, vad


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: softplus(x) - x y, computed as
    max(x, 0) - x y + log1p(exp(-|x|))."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def emotic_loss_fn(params: Dict, feats_norm: torch.Tensor,
                   cat_labels: torch.Tensor, vad_labels: torch.Tensor,
                   valid: torch.Tensor, category_emb: torch.Tensor,
                   alpha: float, scale: float, vad_weight: float,
                   impl: str = "auto") -> torch.Tensor:
    """Masked mean(BCE over 26 categories) + vad_weight * mean L2(VAD)."""
    logits, vad = emotic_forward(params, feats_norm, category_emb, alpha,
                                 scale, impl)
    bce = sigmoid_binary_cross_entropy(logits, cat_labels)  # [B, 26]
    w = valid.float()
    denom = torch.clamp(w.sum(), min=1.0)
    loss = (bce.mean(dim=-1) * w).sum() / denom
    if vad is not None and vad_weight > 0:
        l2 = torch.square(vad - vad_labels).mean(dim=-1)
        loss = loss + vad_weight * (l2 * w).sum() / denom
    return loss


def make_emotic_train_step(tx: Optimizer, alpha: float, scale: float,
                           vad_weight: float, impl: str = "auto"):
    """step(params, opt, count, feats, cats, vad, valid, category_emb) ->
    loss: one Adam update of the head (leaves that require grad, bound to
    ``opt`` by ``tx.init``), update number ``count``."""

    def step(params, opt, count, feats, cats, vad, valid, category_emb):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss = emotic_loss_fn(params, feats, cats, vad, valid, category_emb,
                              alpha, scale, vad_weight, impl)
        loss.backward()
        tx.update(opt, count, [p.grad for p in leaves], None)
        return loss.detach()

    return step


@torch.no_grad()
def encode_all_contexts(clip_params, cfg, dataset, batch_size: int = 64,
                        policy=None) -> torch.Tensor:
    """Frozen-tower features for every context image, once ([N, P] fp32,
    l2-normed, on the params' device); the tail batch is padded to
    ``batch_size`` (fixed shapes, as the reference)."""
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch
    from vlm_clip_tpu_torch.models import clip as C

    policy = policy or BF16
    dev = clip_params["logit_scale"].device
    out = []
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = range(start, min(start + batch_size, n))
        ctx = np.stack([dataset[i][0] for i in idx])
        if ctx.shape[0] < batch_size:  # fixed shapes: pad the tail batch
            reps = batch_size - ctx.shape[0]
            ctx = np.concatenate([ctx, np.repeat(ctx[-1:], reps, 0)])
        px = normalize_batch(torch.from_numpy(ctx).to(dev))
        feats = C.get_image_features(clip_params, px, cfg, policy)
        out.append(feats.float()[:len(idx)])
    return L.l2_normalize(torch.cat(out))


def save_emotic_head(path: str, params: Dict) -> None:
    """Flat-npz export of the adapter + VAD head ('visual/fc1/kernel',
    ...), the reference's format."""

    def flatten(node, prefix=""):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                yield from flatten(v, key)
            else:
                yield key, v.detach().cpu().numpy()

    flat = dict(flatten(params))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, **flat)


def load_emotic_head(path: str, device="cuda") -> Dict:
    """A head saved by :func:`save_emotic_head` (or the reference's) as a
    tree of tensors on ``device``."""
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(z[key]).to(device)
    return out


def train_emotic(clip_params, cfg, tokenizer, dataset,
                 num_epochs: int = 5, batch_size: int = 32,
                 learning_rate: float = 3e-4, alpha: float = 0.2,
                 bottleneck: int = 192, vad_weight: float = 0.5,
                 scale: float = 100.0, with_vad: bool = True,
                 seed: int = 0, policy=None, impl: str = "auto",
                 epoch_seconds: Optional[List[float]] = None
                 ) -> Tuple[Dict, List[float]]:
    """Encode-once EMOTIC training over an EmoticPreDataset-style dataset
    (items: (context_u8, body_u8, cat_onehot, vad)) on the params'
    device. Returns (params, per-epoch losses); each epoch's seconds are
    appended to ``epoch_seconds`` when it is given."""
    from vlm_clip_tpu_torch.eval.emotic import encode_category_embeddings

    dev = clip_params["logit_scale"].device
    category_emb = encode_category_embeddings(clip_params, cfg, tokenizer,
                                              policy)
    feats = encode_all_contexts(clip_params, cfg, dataset, policy=policy)
    n = len(dataset)
    cats = torch.from_numpy(np.stack([dataset[i][2] for i in range(n)])
                            ).to(dev)
    vads = torch.from_numpy(np.stack([dataset[i][3] for i in range(n)])
                            ).to(dev)

    params = init_emotic_head(torch.Generator(device=dev).manual_seed(seed),
                              feats.shape[1], bottleneck, with_vad, dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tx = adam(learning_rate)
    opt = tx.init(leaves)
    step = make_emotic_train_step(tx, alpha, scale, vad_weight, impl)

    rng = np.random.default_rng(seed)
    losses: List[float] = []
    count = 0
    for epoch in range(num_epochs):
        t0 = time.time()
        order = rng.permutation(n)
        epoch_losses = []
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            valid = np.ones((batch_size,), bool)
            if len(idx) < batch_size:  # pad + mask the ragged tail
                valid[len(idx):] = False
                idx = np.concatenate(
                    [idx, np.full(batch_size - len(idx), idx[-1])])
            ti = torch.from_numpy(idx).to(dev)
            epoch_losses.append(step(
                params, opt, count, feats.index_select(0, ti),
                cats.index_select(0, ti), vads.index_select(0, ti),
                torch.from_numpy(valid).to(dev), category_emb))
            count += 1
        mean_loss = float(torch.stack(epoch_losses).mean())
        losses.append(mean_loss)
        seconds = time.time() - t0
        if epoch_seconds is not None:
            epoch_seconds.append(seconds)
        log.info("emotic epoch %d/%d loss %.4f (%.1fs)", epoch + 1,
                 num_epochs, mean_loss, seconds)
    return params, losses
