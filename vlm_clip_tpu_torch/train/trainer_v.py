"""Pipeline-V training loop (port of ``vlm_clip_tpu/train/trainer_v.py``).

Adam over the three adapters, cross-entropy against the class labels,
dropout active in training (its seeds drawn from an explicit CPU
``torch.Generator``, so no draw waits on the card), and a per-epoch
refresh of the adapted class embeddings. The frozen tower's normalized
image features are cached by dataset index (the T trainer's
``FeatureCache``); the context features come with each batch, resolved
once when the dataset was built. From the second epoch on a step is the
three adapters (K6 forward and backward on the card) and a [B, 7]
cross-entropy.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List

import numpy as np
import torch

from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.data.preprocess import normalize_batch
from vlm_clip_tpu_torch.models import model_v as V
from vlm_clip_tpu_torch.train.optim import Optimizer, adam
from vlm_clip_tpu_torch.train.trainer_t import FeatureCache

log = logging.getLogger(__name__)


def make_v_train_step(tx: Optimizer, alpha: float, beta: float,
                      gamma: float, dropout: float,
                      impl: str = "auto") -> Callable:
    """step(adapter_params, opt, count, feats, ctx, labels, emotion_emb,
    logit_scale, generator) -> loss: one Adam update of the adapters
    (leaves that require grad, bound to ``opt`` by ``tx.init``), update
    number ``count``; dropout active when ``generator`` is given."""

    def step(adapter_params, opt, count, feats, ctx, labels, emotion_emb,
             logit_scale, generator):
        params = tree_leaves(adapter_params)
        for p in params:
            p.grad = None
        loss = V.v_loss_fn(adapter_params, feats, ctx, labels, emotion_emb,
                           logit_scale, generator, alpha, beta, gamma,
                           dropout, impl)
        loss.backward()
        tx.update(opt, count, [p.grad for p in params], None)
        return loss.detach()

    return step


def train_model(model: "V.EnhancedCLIPAdapterV", train_loader,
                num_epochs: int = 5, learning_rate: float = 3e-4,
                seed: int = 0,
                cache_image_features: bool = True) -> List[float]:
    """Returns the per-epoch mean losses; updates ``model.adapter_params``
    and the adapted class embeddings in place."""
    if model.emotion_embedding_tensor is None:
        model.encode_emotion_descriptions()
    tx = adam(learning_rate)
    params = model.adapter_params
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = tx.init(tree_leaves(params))
    step = make_v_train_step(tx, model.alpha, model.beta, model.gamma,
                             model.dropout, model.impl)
    gen = torch.Generator().manual_seed(seed)
    scale = model.clip_params["logit_scale"]
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
            ctx = None if batch.context_features is None \
                else torch.from_numpy(batch.context_features).to(device)
            labels = torch.from_numpy(np.asarray(batch.labels)).to(device)
            epoch_losses.append(step(params, opt, count, feats, ctx, labels,
                                     model.emotion_embedding_tensor, scale,
                                     gen))
            count += 1
        mean_loss = float(torch.stack(epoch_losses).mean())
        losses.append(mean_loss)
        msg = (f"Epoch {epoch + 1}/{num_epochs} - Average Training Loss: "
               f"{mean_loss:.4f}")
        print(msg)
        log.info("%s (%.1fs)", msg, time.time() - t0)
        model.adapter_params = params
        model.update_emotion_embeddings()  # the per-epoch refresh
    print("Training complete.")
    return losses
