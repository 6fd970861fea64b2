"""Pipeline-T training loop: adapter-only CE over cached image features
(port of ``vlm_clip_tpu/train/trainer_t.py``).

Reference contract (CLIPAdapter.train): Adam over the two feature
adapters, CE against the class labels, the temperature read once, the
adapted class embeddings refreshed after every epoch. The frozen image
tower's normalized features are computed once per sample and cached on
the device ([N, P] fp32, written in place with ``index_copy_``), keyed
by dataset index: later epochs gather the cached rows for whatever fresh
shuffle the loader produces, so epoch composition and order stay the
reference's and only the frozen-tower recompute is gone. From the second
epoch on a step is the two adapters (K6 forward and backward) and a
[B, 7] cross-entropy.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.data.preprocess import normalize_batch
from vlm_clip_tpu_torch.models import model_t as T
from vlm_clip_tpu_torch.train.optim import Optimizer, adam

log = logging.getLogger(__name__)


def make_t_train_step(tx: Optimizer, alpha: float, beta: float,
                      impl: str = "auto") -> Callable:
    """step(adapter_params, opt, count, feats, labels, mean_emb, scale)
    -> loss: one Adam update of the adapters (leaves that require grad,
    bound to ``opt`` by ``tx.init``), update number ``count``."""

    def step(adapter_params, opt, count, feats, labels, mean_emb, scale):
        params = tree_leaves(adapter_params)
        for p in params:
            p.grad = None
        loss = T.t_loss_fn(adapter_params, feats, labels, mean_emb, alpha,
                           beta, scale, impl)
        loss.backward()
        grads = [p.grad for p in params]
        tx.update(opt, count, grads, None)
        return loss.detach()

    return step


class FeatureCache:
    """Per-sample frozen-feature cache keyed by dataset index: an [N, P]
    fp32 tensor on the device, written in place."""

    def __init__(self, n: int, dim: int, device="cuda"):
        self.feats = torch.zeros(n, dim, dtype=torch.float32, device=device)
        self.have = np.zeros((n,), bool)

    def lookup_or_compute(self, indices: Optional[np.ndarray], compute):
        """Features for the batch; computes and stores them on any miss."""
        if indices is None:
            return compute()
        idx = np.asarray(indices)
        at = torch.as_tensor(idx, dtype=torch.long,
                             device=self.feats.device)
        if self.have[idx].all():
            return self.feats.index_select(0, at)
        feats = compute()
        self.feats.index_copy_(0, at, feats.float())
        self.have[idx] = True
        return feats


def train_t_adapters(model: "T.CLIPAdapterT", train_loader,
                     num_epochs: int = 5, learning_rate: float = 3e-4,
                     cache_image_features: bool = True
                     ) -> Tuple[dict, List[float]]:
    """Returns (trained adapter_params, per-epoch mean losses)."""
    tx = adam(learning_rate)
    params = model.adapter_params
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = tx.init(tree_leaves(params))
    scale = model.temperature
    step = make_t_train_step(tx, model.alpha, model.beta, model.impl)
    device = model.device

    cache = FeatureCache(len(train_loader.dataset), model.feature_dim,
                         device) \
        if cache_image_features and hasattr(train_loader, "dataset") \
        else None
    losses: List[float] = []
    count = 0
    for epoch in range(num_epochs):
        t0 = time.time()
        epoch_losses = []
        for batch in train_loader:
            def compute(b=batch):
                px = normalize_batch(torch.from_numpy(b.images).to(device))
                return model.encode_images(px)

            feats = cache.lookup_or_compute(batch.indices, compute) \
                if cache is not None else compute()
            labels = torch.from_numpy(np.asarray(batch.labels)).to(device)
            epoch_losses.append(step(params, opt, count, feats, labels,
                                     model.bank.mean, scale))
            count += 1
        mean_loss = float(torch.stack(epoch_losses).mean())
        losses.append(mean_loss)
        log.info("epoch %d/%d loss %.4f (%.1fs)", epoch + 1, num_epochs,
                 mean_loss, time.time() - t0)
        # per-epoch class-embedding refresh for eval
        model.adapter_params = params
        model.update_emotion_embeddings()
    return params, losses
