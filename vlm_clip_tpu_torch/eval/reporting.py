"""Pipeline-V evaluation, its text report and the VLM context analytics
(port of ``vlm_clip_tpu/eval/reporting.py``).

- :func:`evaluate_enhanced_model`: the batched predict loop over (image,
  label, path, context features, description) items; its
  :class:`EvalResult`'s ``astuple()`` is the reference's 9-tuple
  (accuracy, confusion matrix, report, predictions, labels, paths,
  confidences, probabilities, contexts). The metrics are the port's
  numpy ``confusion_matrix`` and ``classification_report`` (the text of
  scikit-learn's, 4 digits), so no scikit-learn is needed;
- :func:`display_results_with_contexts`: the console report with each
  class's most confident correct and incorrect samples and their
  contexts; the confusion matrix is printed as pandas prints it, without
  pandas, and plotted only when ``plots`` is on (matplotlib);
- :func:`analyze_context_quality`: the success rate, mean length and the
  top-5 stopword-filtered keywords a class of the VLM's descriptions.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import List, Sequence

import numpy as np
import torch

from vlm_clip_tpu_torch.core.config import EMOTIONS
from vlm_clip_tpu_torch.data.enhanced import ERROR_DESCRIPTION, NO_DESCRIPTION
from vlm_clip_tpu_torch.data.preprocess import normalize_batch
from vlm_clip_tpu_torch.eval.evaluate import (EvalResult,
                                              classification_report,
                                              confusion_matrix)

_STOPWORDS = frozenset([
    "the", "a", "is", "in", "it", "of", "and", "to", "this", "person",
    "image", "facial", "expression", "face", "shows", "appears", "seems",
    "like", "with", "their",
])


def evaluate_enhanced_model(model, test_loader,
                            emotions: Sequence[str] = EMOTIONS
                            ) -> EvalResult:
    """The no-grad predict loop on the model's device and the metrics;
    padded rows (``Batch.valid``) are dropped first."""
    device = model.clip_params["logit_scale"].device
    probs_l, labels_l, paths, contexts = [], [], [], []
    for batch in test_loader:
        px = normalize_batch(torch.from_numpy(batch.images).to(device))
        probs = model.predict_probs(px, batch.context_features)
        probs = probs.float().cpu().numpy()
        valid = batch.valid if batch.valid is not None \
            else np.ones((batch.size,), bool)
        probs_l.append(probs[valid])
        labels_l.append(np.asarray(batch.labels)[valid])
        if batch.paths is not None:
            paths.extend(p for p, v in zip(batch.paths, valid) if v)
        if batch.contexts is not None:
            contexts.extend(c for c, v in zip(batch.contexts, valid) if v)

    probs = np.concatenate(probs_l)
    labels = np.concatenate(labels_l)
    preds = probs.argmax(axis=1)
    acc = float(np.mean(preds == labels)) if len(labels) else 0.0
    cm = confusion_matrix(labels, preds, len(emotions))
    report = classification_report(labels, preds, list(emotions), digits=4)
    return EvalResult(accuracy=acc, conf_matrix=cm, class_report=report,
                      predictions=preds, labels=labels, image_paths=paths,
                      confidences=probs.max(axis=1),
                      similarity_scores=probs, contexts=contexts)


def format_matrix(matrix: np.ndarray, names: Sequence[str]) -> str:
    """An integer matrix with row and column labels, as
    ``str(pandas.DataFrame(matrix, index=names, columns=names))`` prints
    it: the labels left-aligned, each column right-aligned to its widest
    entry, two spaces between columns."""
    names = list(names)
    iw = max(len(n) for n in names)
    widths = [max(len(n), max(len(str(v)) for v in matrix[:, j]))
              for j, n in enumerate(names)]
    lines = [" " * iw + "".join(f"  {n.rjust(w)}"
                                for n, w in zip(names, widths))]
    for name, row in zip(names, matrix):
        lines.append(name.ljust(iw) + "".join(
            f"  {str(v).rjust(w)}" for v, w in zip(row, widths)))
    return "\n".join(lines)


def display_results_with_contexts(results: EvalResult,
                                  emotions: Sequence[str] = EMOTIONS,
                                  num_samples_per_class: int = 3,
                                  out_dir: str = ".",
                                  plots: bool = True) -> None:
    """Console report incl. each class's most confident correct and
    incorrect samples with their VLM contexts."""
    print(f"\n{'=' * 60}")
    print("ENHANCED CLIP-ADAPTER EVALUATION RESULTS")
    print(f"{'=' * 60}")
    print(f"Overall Accuracy: {results.accuracy:.4f}")

    print(f"\n{'=' * 40}\nCONFUSION MATRIX\n{'=' * 40}")
    print(format_matrix(results.conf_matrix, emotions))
    if plots:
        from vlm_clip_tpu_torch.eval.plots import plot_confusion_matrix

        path = plot_confusion_matrix(results.conf_matrix, "Confusion Matrix",
                                     emotions, out_dir)
        print(f"\nConfusion matrix plot saved as {os.path.basename(path)}")

    print(f"\n{'=' * 40}\nCLASSIFICATION REPORT\n{'=' * 40}")
    print(results.class_report)

    print(f"\n{'=' * 60}")
    print("SAMPLE CONTEXT DESCRIPTIONS BY TRUE EMOTION CLASS")
    print(f"{'=' * 60}")
    contexts = results.contexts or [""] * len(results.labels)
    paths = results.image_paths or [""] * len(results.labels)
    for idx, name in enumerate(emotions):
        print(f"\n{'-' * 50}\nEMOTION (TRUE): {name.upper()}\n{'-' * 50}")
        rows = [i for i, l in enumerate(results.labels) if l == idx]
        if not rows:
            print("No samples found for this emotion.")
            continue
        rows.sort(key=lambda i: results.confidences[i], reverse=True)
        correct = [i for i in rows if results.predictions[i] == idx]
        wrong = [i for i in rows if results.predictions[i] != idx]
        print(f"Total samples for {name}: {len(rows)}")
        print(f"Correct predictions: {len(correct)}")
        print(f"Incorrect predictions: {len(wrong)}")

        def show(tag, idxs, cap):
            if not idxs:
                return
            print(f"\n  {tag} (True: {name}):")
            for j, i in enumerate(idxs[:cap]):
                print(f"\n    Sample {j + 1}:")
                print(f"      Image: {os.path.basename(paths[i])}")
                print(f"      Predicted: "
                      f"{emotions[results.predictions[i]]} "
                      f"(Confidence: {results.confidences[i]:.4f})")
                print(f"      Context: {contexts[i]}")

        show("TOP CORRECT PREDICTIONS", correct, num_samples_per_class)
        show("TOP INCORRECT PREDICTIONS", wrong,
             min(2, num_samples_per_class))
    print(f"\n{'=' * 60}")


def analyze_context_quality(all_contexts_text: List[str],
                            all_labels,
                            emotions: Sequence[str] = EMOTIONS) -> dict:
    """VLM description analytics; returns the statistics it prints."""
    print(f"\n{'=' * 60}\nCONTEXT DESCRIPTION ANALYSIS\n{'=' * 60}")
    stats = {"total": 0, "valid": 0, "success_rate": None,
             "avg_length": None, "keywords": {}}
    if not all_contexts_text:
        print("No context descriptions provided for analysis.")
        return stats

    def is_valid(c):
        return bool(c) and c.strip() not in (NO_DESCRIPTION,
                                             ERROR_DESCRIPTION)

    valid = [c for c in all_contexts_text if is_valid(c)]
    stats["total"] = len(all_contexts_text)
    stats["valid"] = len(valid)
    print(f"Total contexts processed: {stats['total']}")
    print(f"Valid contexts generated: {stats['valid']}")
    if stats["total"]:
        stats["success_rate"] = 100.0 * stats["valid"] / stats["total"]
        print(f"VLM Context Generation Success Rate: "
              f"{stats['success_rate']:.2f}%")

    if valid:
        stats["avg_length"] = sum(len(c.split()) for c in valid) / len(valid)
        print(f"Average valid context length: {stats['avg_length']:.1f} "
              "words")
        print("\nCOMMON KEYWORDS IN VALID CONTEXTS BY TRUE EMOTION:")
        labels = np.asarray(all_labels)
        for idx, name in enumerate(emotions):
            cls_ctx = [all_contexts_text[i] for i in range(len(labels))
                       if labels[i] == idx and is_valid(all_contexts_text[i])]
            if not cls_ctx:
                print(f"  {name.capitalize()}: No valid contexts found for "
                      "this emotion.")
                continue
            words = []
            for c in cls_ctx:
                for w in c.split():
                    w = w.lower().strip('.,!?";:')
                    if len(w) > 3 and w not in _STOPWORDS:
                        words.append(w)
            if words:
                top = [w for w, _ in Counter(words).most_common(5)]
                stats["keywords"][name] = top
                print(f"  {name.capitalize()}: {top}")
            else:
                print(f"  {name.capitalize()}: No significant keywords "
                      "found after filtering.")
    print(f"\n{'=' * 60}")
    return stats
