"""EMOTIC evaluation: CLIP zero-shot / adapter scoring + mAP (port of
``vlm_clip_tpu/eval/emotic.py``).

Scores the 26 EMOTIC categories with CLIP class-text embeddings
(zero-shot, or through a T-style visual adapter: ``adapt_features``,
kernel K6 forward on a card) and computes multi-label mAP. Scoring uses
CLIP's own normalization stats on the context image (the EMOTIC
context/body stats in data/emotic.py exist for parity with the
reference's external CNN pipeline).

:func:`mean_average_precision` is numpy: it computes what the reference's
``sklearn.metrics.average_precision_score`` does, step for step, so the
card's machine needs no scikit-learn.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from vlm_clip_tpu_torch.data.emotic import EMOTIC_CATEGORIES

CATEGORY_PROMPT = "a photo of a person feeling {}"


def _device(clip_params) -> torch.device:
    return clip_params["logit_scale"].device


@torch.no_grad()
def encode_category_embeddings(clip_params, cfg, tokenizer, policy=None,
                               categories: Sequence[str] =
                               EMOTIC_CATEGORIES) -> torch.Tensor:
    """[26, P] normalized category-text embeddings, one batched forward,
    fp32 on the params' device."""
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.models import clip as C
    from vlm_clip_tpu_torch.models import layers as L

    policy = policy or BF16
    dev = _device(clip_params)
    texts = [CATEGORY_PROMPT.format(c.lower()) for c in categories]
    ids, mask = tokenizer(texts)
    feats = C.get_text_features(clip_params, torch.from_numpy(ids).to(dev),
                                torch.from_numpy(mask).to(dev), cfg, policy)
    return L.l2_normalize(feats).float()


def emotic_scores(clip_params, cfg, category_emb, context_u8,
                  adapter_params=None, alpha: float = 0.2, policy=None,
                  impl: str = "auto") -> torch.Tensor:
    """[B, 26] cosine scores for a uint8 context batch (numpy or tensor).

    ``adapter_params``: optional T-style {'visual': ...} feature adapter
    (alpha-blended) on top of the frozen features; ``impl`` as in
    ``models.adapters.adapt_features``.
    """
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch
    from vlm_clip_tpu_torch.models import adapters as A
    from vlm_clip_tpu_torch.models import clip as C
    from vlm_clip_tpu_torch.models import layers as L

    policy = policy or BF16
    with torch.no_grad():
        px = normalize_batch(torch.as_tensor(context_u8).to(
            _device(clip_params)))
        feats = C.get_image_features(clip_params, px, cfg, policy)
        feats = L.l2_normalize(feats).float()
        if adapter_params is not None:
            feats = A.adapt_features(adapter_params["visual"], feats, alpha,
                                     impl=impl)
        return feats @ category_emb.T


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary average precision, as ``sklearn.metrics.
    average_precision_score``: AP = sum_n (R_n - R_{n-1}) P_n over the
    distinct score thresholds, descending; tied scores are one threshold.
    The same operations in the same order as sklearn's
    ``precision_recall_curve``."""
    y_true = np.ravel(y_true) == 1
    y_score = np.ravel(y_score)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    y_true = y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true * 1.0, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=(ps != 0))
    recall = tps / tps[-1]
    precision = np.hstack((precision[::-1], 1))
    recall = np.hstack((recall[::-1], 0))
    # the last precision is 1; rounding can give -0.0, clipped as sklearn
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def mean_average_precision(scores: np.ndarray, labels: np.ndarray
                           ) -> Tuple[float, np.ndarray]:
    """(mAP, per-class AP) over multi-label scores; classes with no
    positive ground truth get AP = nan and are excluded from the mean."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    C = labels.shape[1]
    aps = np.full((C,), np.nan)
    for c in range(C):
        if labels[:, c].sum() > 0:
            aps[c] = average_precision(labels[:, c], scores[:, c])
    return float(np.nanmean(aps)), aps


def evaluate_emotic(clip_params, cfg, tokenizer, loader,
                    adapter_params=None, alpha: float = 0.2,
                    policy=None, impl: str = "auto") -> dict:
    """Full loop: batched scoring over an EmoticBatch loader -> mAP dict
    (``scores``: the valid rows' [N, 26] scores, numpy)."""
    category_emb = encode_category_embeddings(clip_params, cfg, tokenizer,
                                              policy)
    all_scores, all_labels = [], []
    for batch in loader:
        s = emotic_scores(clip_params, cfg, category_emb, batch.context,
                          adapter_params, alpha, policy, impl)
        s = s.cpu().numpy()
        valid = batch.valid
        all_scores.append(s[valid])
        all_labels.append(batch.cat[valid])
    scores = np.concatenate(all_scores)
    labels = np.concatenate(all_labels)
    m, aps = mean_average_precision(scores, labels)
    return {
        "mAP": m,
        "per_class_ap": {EMOTIC_CATEGORIES[i]: float(aps[i])
                         for i in range(len(EMOTIC_CATEGORIES))},
        "num_samples": int(labels.shape[0]),
        "scores": scores,
    }
