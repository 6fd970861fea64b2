"""Plot artifacts (copied from ``vlm_clip_tpu/eval/plots.py``: numpy, PIL
and matplotlib only, the class names from the port's ``core/config``).

Confusion-matrix heatmap, per-true-class mean probability bars, and
correct/incorrect prediction grids, each saved as a png named from its
(sanitized) title. matplotlib (Agg backend) and seaborn are imported
inside each function, so hosts without them can import this module.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from vlm_clip_tpu_torch.core.config import EMOTIONS


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _save(fig, title: str, out_dir: str = ".") -> str:
    fname = title.lower().replace(" ", "_").replace("(", "").replace(")", "")
    path = os.path.join(out_dir, f"{fname}.png")
    fig.savefig(path, bbox_inches="tight", dpi=120)
    return path


def plot_confusion_matrix(conf_matrix: np.ndarray,
                          title: str = "Confusion Matrix",
                          class_names: Sequence[str] = EMOTIONS,
                          out_dir: str = ".") -> str:
    """Heatmap png."""
    plt = _plt()
    import seaborn as sns
    fig, ax = plt.subplots(figsize=(10, 8))
    sns.heatmap(conf_matrix, annot=True, fmt="d", cmap="Blues",
                xticklabels=list(class_names), yticklabels=list(class_names),
                ax=ax)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    path = _save(fig, title, out_dir)
    plt.close(fig)
    return path


def plot_class_similarities(similarity_scores: np.ndarray,
                            labels: np.ndarray,
                            title: str = "Class Similarities",
                            class_names: Sequence[str] = EMOTIONS,
                            out_dir: str = ".") -> str:
    """Per-true-class mean probability grouped bars."""
    plt = _plt()
    C = len(class_names)
    means = np.zeros((C, C))
    for c in range(C):
        m = labels == c
        if m.any():
            means[c] = similarity_scores[m].mean(axis=0)
    fig, ax = plt.subplots(figsize=(12, 8))
    x = np.arange(C)
    width = 0.8 / C
    for pred_c in range(C):
        ax.bar(x + pred_c * width - 0.4 + width / 2, means[:, pred_c],
               width, label=class_names[pred_c])
    ax.set_xticks(x)
    ax.set_xticklabels(list(class_names), rotation=45)
    ax.set_xlabel("True class")
    ax.set_ylabel("Mean predicted probability")
    ax.set_title(title)
    ax.legend(fontsize=8)
    path = _save(fig, title, out_dir)
    plt.close(fig)
    return path


def visualize_predictions(image_paths: List[str], labels: np.ndarray,
                          predictions: np.ndarray,
                          confidences: np.ndarray, num_examples: int = 5,
                          title: str = "Predictions",
                          class_names: Sequence[str] = EMOTIONS,
                          out_dir: str = ".") -> Optional[str]:
    """Correct/incorrect sample-image grids."""
    if not image_paths:
        return None
    plt = _plt()
    from PIL import Image

    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    correct = np.nonzero(predictions == labels)[0][:num_examples]
    wrong = np.nonzero(predictions != labels)[0][:num_examples]
    rows = [("Correct", correct), ("Incorrect", wrong)]
    fig, axes = plt.subplots(2, num_examples, figsize=(3 * num_examples, 7))
    for r, (tag, idxs) in enumerate(rows):
        for c in range(num_examples):
            ax = axes[r, c] if num_examples > 1 else axes[r]
            ax.axis("off")
            if c >= len(idxs):
                continue
            i = int(idxs[c])
            try:
                ax.imshow(Image.open(image_paths[i]).convert("RGB"))
            except Exception:
                continue
            ax.set_title(
                f"{tag}\nT:{class_names[labels[i]]} "
                f"P:{class_names[predictions[i]]}\n{confidences[i]:.2f}",
                fontsize=8)
    fig.suptitle(title)
    path = _save(fig, title, out_dir)
    plt.close(fig)
    return path
