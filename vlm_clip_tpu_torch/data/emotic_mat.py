"""EMOTIC Annotations.mat -> csv/npy converter (offline CLI; copied from
``vlm_clip_tpu/data/emotic_mat.py``).

A host tool: it runs where the EMOTIC archive is, never on the card's
path. ``cv2`` (the reference's resize, whose bytes the npy files must
reproduce) is imported only inside :func:`prepare_data`.

Rebuild of the reference's converter (dataset/mat2py.py:12-290, itself
derived from the public Tandon-A/emotic tooling). Same outputs:

- ``{split}.csv`` with columns Index, Folder, Filename, Image Size, BBox,
  Categorical_Labels, Continuous_Labels, Gender, Age;
- optional ``{split}_{context,body,cat,cont}_arr.npy`` preprocessed
  tensors (224^2 context, 128^2 body, 26-dim one-hot, raw VAD).

Behavior contracts preserved: bbox clamped to the annotated image size
(mat2py.py:37-43), persons skipped when the image is missing, unreadable,
or has zero cat/cont annotators (mat2py.py:176-216); test/val splits use
the combined annotator labels; debug mode caps at ~104 persons.

The .mat leaves are deeply nested object arrays; :func:`_scalar` /
:func:`_seq` unwrap them uniformly instead of the reference's repeated
flatten-tolist chains.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Sequence

import numpy as np

from vlm_clip_tpu_torch.data.emotic import cat_to_one_hot


def _scalar(x):
    """Unwrap nested 1-element object arrays to a python scalar."""
    a = np.asarray(x).flatten()
    while a.size and isinstance(a[0], np.ndarray):
        a = np.asarray(a[0]).flatten()
    return a[0] if a.size else None


def _seq(x) -> List:
    """Unwrap a nested object array into a flat python list of scalars."""
    a = np.asarray(x).flatten()
    out = []
    for item in a:
        if isinstance(item, np.ndarray):
            out.extend(_seq(item))
        else:
            out.append(item)
    return out


def _clamp_bbox(bbox: Sequence[float], rows: int, cols: int) -> List[int]:
    x1, y1, x2, y2 = bbox
    # reference clamps x to rows and y to cols (mat2py.py:37-43) — kept
    # verbatim for output parity even though it swaps axes
    x1 = min(rows, max(0, x1))
    x2 = min(rows, max(0, x2))
    y1 = min(cols, max(0, y1))
    y2 = min(cols, max(0, y2))
    return [int(x1), int(y1), int(x2), int(y2)]


class PersonAnnotation:
    """One annotated person; parses train- or test-layout records."""

    def __init__(self, filename: str, folder: str, image_size, person,
                 split: str):
        self.filename = filename
        self.folder = folder
        size = np.asarray(_scalar(image_size))
        sz = _seq(image_size)
        self.im_size = [int(sz[0]), int(sz[1])]
        self.bbox = _clamp_bbox([float(v) for v in _seq(person[0])[:4]],
                                self.im_size[0], self.im_size[1])
        if split == "train":
            self.cat = [str(c) for c in _seq(person[1])]
            self.cont = [float(c) for c in _seq(person[2])]
            self.gender = str(_scalar(person[3]))
            self.age = str(_scalar(person[4]))
            self.cat_annotators = 1 if self.cat else 0
            self.cont_annotators = 0 if any(
                np.isnan(c) for c in self.cont) else 1
            self.comb_cat = self.cat
            self.comb_cont = self.cont
        else:
            per_ann = person[1][0] if len(person[1]) else []
            self.cat = [[str(c) for c in _seq(a)] for a in per_ann]
            self.cat_annotators = len(self.cat)
            self.comb_cat = [str(c) for c in _seq(person[2])] \
                if self.cat_annotators else []
            per_cont = person[3][0] if len(person[3]) else []
            self.cont = [[float(c) for c in _seq(a)] for a in per_cont]
            self.cont_annotators = len(self.cont)
            self.comb_cont = [float(c) for c in _seq(person[4])] \
                if self.cont_annotators else []
            self.gender = str(_scalar(person[5]))
            self.age = str(_scalar(person[6]))
            if any(np.isnan(c) for c in self.comb_cont):
                self.cont_annotators = 0

    def csv_labels(self, split: str):
        if split == "train":
            return self.cat, self.cont
        return self.comb_cat, self.comb_cont


def prepare_data(data_mat, data_path_src: str, save_dir: str,
                 dataset_type: str = "train", generate_npy: bool = False,
                 debug_mode: bool = False) -> str:
    """Convert one split. Returns the csv path (mat2py.py:155-250)."""
    import cv2

    kept: List[PersonAnnotation] = []
    ctx_arr, body_arr, cat_arr, cont_arr = [], [], [], []
    n_err = n_missing = n_unannotated = 0
    idx = 0
    for ex in data_mat[0]:
        persons = ex[4][0]
        for person in persons:
            ann = PersonAnnotation(str(_scalar(ex[0])), str(_scalar(ex[1])),
                                   ex[2], person, dataset_type)
            image_path = os.path.join(data_path_src, ann.folder,
                                      ann.filename)
            if not os.path.exists(image_path):
                n_missing += 1
                continue
            try:
                context = cv2.cvtColor(cv2.imread(image_path),
                                       cv2.COLOR_BGR2RGB)
                x1, y1, x2, y2 = ann.bbox
                body = context[y1:y2, x1:x2].copy()
                context_cv = cv2.resize(context, (224, 224))
                body_cv = cv2.resize(body, (128, 128))
            except Exception as e:
                n_err += 1
                if debug_mode:
                    print(f"skipping idx={idx}: {e!r}")
                continue
            if ann.cat_annotators == 0 or ann.cont_annotators == 0:
                n_unannotated += 1
                continue
            kept.append(ann)
            if generate_npy:
                cats, cont = ann.csv_labels(dataset_type)
                ctx_arr.append(context_cv)
                body_arr.append(body_cv)
                cat_arr.append(cat_to_one_hot(cats))
                cont_arr.append(np.asarray(cont, np.float32))
            idx += 1
            if idx % (20 if debug_mode else 1000) == 0:
                print(f" Preprocessing data. Index = {idx}")
        if debug_mode and idx >= 104:
            print(f"debug mode: stopping at {idx} persons")
            break
    print(f"errors={n_err} missing={n_missing} "
          f"unannotated={n_unannotated} kept={len(kept)}")

    os.makedirs(save_dir, exist_ok=True)
    csv_path = os.path.join(save_dir, f"{dataset_type}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, delimiter=",", dialect="excel")
        w.writerow(["Index", "Folder", "Filename", "Image Size", "BBox",
                    "Categorical_Labels", "Continuous_Labels", "Gender",
                    "Age"])
        for i, ann in enumerate(kept):
            cats, cont = ann.csv_labels(dataset_type)
            w.writerow([i, ann.folder, ann.filename, ann.im_size, ann.bbox,
                        cats, cont, ann.gender, ann.age])
    print("wrote file", csv_path)

    if generate_npy:
        for name, arr in (("context", ctx_arr), ("body", body_arr),
                          ("cat", cat_arr), ("cont", cont_arr)):
            np.save(os.path.join(save_dir,
                                 f"{dataset_type}_{name}_arr.npy"),
                    np.asarray(arr))
        print(f"saved npy arrays for {dataset_type} "
              f"({len(ctx_arr)} samples)")
    return csv_path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="EMOTIC Annotations.mat -> "
                                            "csv/npy converter")
    p.add_argument("--data_dir", required=True,
                   help="EMOTIC root (Annotations/ + emotic/ inside)")
    p.add_argument("--save_dir_name", default="emotic_pre")
    p.add_argument("--label", default="all",
                   choices=["train", "val", "test", "all"])
    p.add_argument("--generate_npy", action="store_true")
    p.add_argument("--debug_mode", action="store_true")
    args = p.parse_args(argv)

    from scipy.io import loadmat

    ann_path = os.path.join(args.data_dir, "Annotations",
                            "Annotations.mat")
    data_path = os.path.join(args.data_dir, "emotic")
    save_path = os.path.join(args.data_dir, args.save_dir_name)
    print("loading Annotations")
    mat = loadmat(ann_path)
    labels = ["train", "val", "test"] if args.label == "all" \
        else [args.label]
    for label in labels:
        print("starting label", label)
        prepare_data(mat[label], data_path, save_path, dataset_type=label,
                     generate_npy=args.generate_npy,
                     debug_mode=args.debug_mode)


if __name__ == "__main__":
    main()
