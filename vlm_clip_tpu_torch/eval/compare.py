"""Zero-shot vs adapter 2x2 comparison harness (port of
``vlm_clip_tpu/eval/compare.py``).

Evaluates {zero-shot, adapter} x {avg-description, all-descriptions},
prints accuracies, improvement deltas and classification reports in the
reference's words, optionally saves the confusion/similarity/prediction
plots, and returns the accuracy dict with the reference's keys.
"""

from __future__ import annotations

from typing import Dict

from vlm_clip_tpu_torch.eval.evaluate import evaluate_model
from vlm_clip_tpu_torch.eval.plots import (plot_class_similarities,
                                           plot_confusion_matrix,
                                           visualize_predictions)


def compare_models(clip_adapter, zero_shot_model, test_loader,
                   use_all_descriptions: bool = True, plots: bool = True,
                   out_dir: str = ".") -> Dict[str, float]:
    grid = {}
    print("\nEvaluating Zero-Shot model with averaged descriptions...")
    grid["zs_avg"] = evaluate_model(zero_shot_model, test_loader, False)
    if use_all_descriptions:
        print("\nEvaluating Zero-Shot model with all descriptions...")
        grid["zs_all"] = evaluate_model(zero_shot_model, test_loader, True)
    print("\nEvaluating CLIP-Adapter with averaged descriptions...")
    grid["ad_avg"] = evaluate_model(clip_adapter, test_loader, False)
    if use_all_descriptions:
        print("\nEvaluating CLIP-Adapter with all descriptions...")
        grid["ad_all"] = evaluate_model(clip_adapter, test_loader, True)

    if plots:
        titles = {
            "zs_avg": ("Zero-Shot Confusion Matrix (Avg Descriptions)",
                       "Zero-Shot Similarity (Avg Descriptions)",
                       "Zero-Shot Predictions (Avg Descriptions)"),
            "zs_all": ("Zero-Shot Confusion Matrix (All Descriptions)",
                       "Zero-Shot Similarity (All Descriptions)",
                       "Zero-Shot Predictions (All Descriptions)"),
            "ad_avg": ("CLIP-Adapter Confusion Matrix (Avg Descriptions)",
                       "CLIP-Adapter Similarity (Avg Descriptions)",
                       "CLIP-Adapter Predictions (Avg Descriptions)"),
            "ad_all": ("CLIP-Adapter Confusion Matrix (All Descriptions)",
                       "CLIP-Adapter Similarity (All Descriptions)",
                       "CLIP-Adapter Predictions (All Descriptions)"),
        }
        for key, res in grid.items():
            cm_t, sim_t, pred_t = titles[key]
            plot_confusion_matrix(res.conf_matrix, cm_t, out_dir=out_dir)
            plot_class_similarities(res.similarity_scores, res.labels,
                                    sim_t, out_dir=out_dir)
            visualize_predictions(res.image_paths, res.labels,
                                  res.predictions, res.confidences,
                                  title=pred_t, out_dir=out_dir)

    zs, ad = grid["zs_avg"].accuracy, grid["ad_avg"].accuracy
    print("\n=== Performance Comparison ===")
    print(f"Zero-Shot Accuracy (Avg Descriptions): {zs:.4f}")
    if use_all_descriptions:
        print(f"Zero-Shot Accuracy (All Descriptions): "
              f"{grid['zs_all'].accuracy:.4f}")
    print(f"CLIP-Adapter Accuracy (Avg Descriptions): {ad:.4f}")
    if use_all_descriptions:
        print(f"CLIP-Adapter Accuracy (All Descriptions): "
              f"{grid['ad_all'].accuracy:.4f}")
    print("\n=== Improvements ===")
    print(f"Adapter vs Zero-Shot (Avg Descriptions): {(ad - zs) * 100:.2f}%")
    if use_all_descriptions:
        zsa, ada = grid["zs_all"].accuracy, grid["ad_all"].accuracy
        print(f"Adapter vs Zero-Shot (All Descriptions): "
              f"{(ada - zsa) * 100:.2f}%")
        print(f"All Descriptions vs Avg (Zero-Shot): "
              f"{(zsa - zs) * 100:.2f}%")
        print(f"All Descriptions vs Avg (CLIP-Adapter): "
              f"{(ada - ad) * 100:.2f}%")
        print(f"Best performance - CLIP-Adapter (All Descriptions): "
              f"{ada:.4f}")
    print("\n=== Zero-Shot Classification Report (Avg Descriptions) ===")
    print(grid["zs_avg"].class_report)
    if use_all_descriptions:
        print("\n=== Zero-Shot Classification Report (All Descriptions) ===")
        print(grid["zs_all"].class_report)
    print("\n=== CLIP-Adapter Classification Report (Avg Descriptions) ===")
    print(grid["ad_avg"].class_report)
    if use_all_descriptions:
        print("\n=== CLIP-Adapter Classification Report "
              "(All Descriptions) ===")
        print(grid["ad_all"].class_report)

    results = {"zero_shot_accuracy_avg": zs, "adapter_accuracy_avg": ad}
    if use_all_descriptions:
        results.update({
            "zero_shot_accuracy_all": grid["zs_all"].accuracy,
            "adapter_accuracy_all": grid["ad_all"].accuracy,
        })
    return results
