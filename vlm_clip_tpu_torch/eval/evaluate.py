"""Batched evaluation core (port of ``vlm_clip_tpu/eval/evaluate.py``).

``evaluate_model`` mirrors the reference's 8-tuple (accuracy, confusion
matrix, classification report, predictions, labels, image paths,
confidences, per-class probability matrix) in a dataclass, with the tuple
from ``astuple()``; ``contexts`` is the 9th element of the enhanced (V)
path. The metrics are computed in numpy (the reference calls
scikit-learn): accuracy, the confusion matrix over every class, and the
text of ``sklearn.metrics.classification_report(..., zero_division=0)``.
Padded rows of the loader's last batch (``Batch.valid``) are dropped
before the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from vlm_clip_tpu_torch.core.config import EMOTIONS
from vlm_clip_tpu_torch.data.preprocess import normalize_batch


@dataclasses.dataclass
class EvalResult:
    accuracy: float
    conf_matrix: np.ndarray
    class_report: str
    predictions: np.ndarray
    labels: np.ndarray
    image_paths: List[str]
    confidences: np.ndarray
    similarity_scores: np.ndarray  # [N, C] probability matrix
    contexts: Optional[List[str]] = None  # V pipeline

    def astuple(self):
        t = (self.accuracy, self.conf_matrix, self.class_report,
             self.predictions, self.labels, self.image_paths,
             self.confidences, self.similarity_scores)
        return t if self.contexts is None else t + (self.contexts,)


def confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                     n_classes: int) -> np.ndarray:
    """[true, predicted] counts over classes 0..n_classes-1."""
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (np.asarray(labels), np.asarray(preds)), 1)
    return cm


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (zero_division=0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def classification_report(labels: np.ndarray, preds: np.ndarray,
                          target_names: Sequence[str],
                          digits: int = 2) -> str:
    """The text of scikit-learn's ``classification_report(labels, preds,
    labels=range(C), target_names=..., zero_division=0)``: per-class
    precision, recall, F1 and support, then accuracy, macro and
    support-weighted averages."""
    cm = confusion_matrix(labels, preds, len(target_names))
    tp = np.diag(cm)
    pred_sum, true_sum = cm.sum(axis=0), cm.sum(axis=1)
    if not tp.any():
        # scikit-learn counts in floats when no prediction is right, so
        # its support column then reads "5.0"
        true_sum = true_sum.astype(np.float64)
    p, r = _divide(tp, pred_sum), _divide(tp, true_sum)
    f1 = _divide(2 * tp, true_sum + pred_sum)
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in target_names), len("weighted avg"),
                digits)
    report = ("{:>{width}s} " + " {:>9}" * 4).format("", *headers,
                                                     width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(target_names, p, r, f1, true_sum):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    support = true_sum.sum()
    acc = float(_divide(tp.sum(), support))
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}"
               + " {:>9}\n").format("accuracy", "", "", acc, support,
                                    width=width, digits=digits)
    for name, avg in (("macro avg", lambda x: float(np.average(x))),
                      ("weighted avg", lambda x: float(
                          np.average(x, weights=true_sum)) if support
                       else 0.0)):
        report += row_fmt.format(name, avg(p), avg(r), avg(f1), support,
                                 width=width, digits=digits)
    return report


def evaluate_model(model, test_loader, use_all_descriptions: bool = False,
                   class_names: Sequence[str] = EMOTIONS) -> EvalResult:
    """Run the batched no-grad predict loop and compute the metrics. The
    batches go to the model's device (``model.clip_params``)."""
    device = model.clip_params["logit_scale"].device
    all_probs, all_labels, all_paths = [], [], []
    for batch in test_loader:
        px = normalize_batch(torch.from_numpy(batch.images).to(device))
        with torch.no_grad():
            probs = model.predict_with_all_descriptions(px) \
                if use_all_descriptions else model.predict(px)
        probs = probs.float().cpu().numpy()
        valid = batch.valid if batch.valid is not None \
            else np.ones((batch.size,), bool)
        all_probs.append(probs[valid])
        all_labels.append(np.asarray(batch.labels)[valid])
        if batch.paths is not None:
            all_paths.extend(p for p, v in zip(batch.paths, valid) if v)

    probs = np.concatenate(all_probs)
    labels = np.concatenate(all_labels)
    preds = probs.argmax(axis=1)
    confidences = probs.max(axis=1)
    acc = float(np.mean(preds == labels)) if len(labels) else 0.0
    cm = confusion_matrix(labels, preds, len(class_names))
    report = classification_report(labels, preds, list(class_names))
    return EvalResult(accuracy=acc, conf_matrix=cm, class_report=report,
                      predictions=preds, labels=labels,
                      image_paths=all_paths, confidences=confidences,
                      similarity_scores=probs)
