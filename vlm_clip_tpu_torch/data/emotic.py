"""EMOTIC dataset loaders (copied from ``vlm_clip_tpu/data/emotic.py``;
reference dataset/emotic.py:11-64).

26-category multi-label + continuous VAD annotations over (context image,
body crop) pairs. Two sources, mirroring the reference:

- :class:`EmoticPreDataset` — preprocessed npy arrays (224^2 context,
  128^2 body crops) written by the mat converter
  (data/emotic_mat.py), with separate context/body normalization stats;
- :class:`EmoticCSVDataset` — csv rows decoded at runtime: open image,
  crop the person bbox, resize 224/128, one-hot the 26 categories, divide
  continuous VAD labels by 10 (emotic.py:50-58).

Items are uint8 HWC; normalization happens on the batch's device
(normalize_emotic_batch, torch) so host->device moves 4x fewer bytes.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


# 26 EMOTIC categories (reference dataset/mat2py.py:272-274)
EMOTIC_CATEGORIES: Tuple[str, ...] = (
    "Affection", "Anger", "Annoyance", "Anticipation", "Aversion",
    "Confidence", "Disapproval", "Disconnection", "Disquietment",
    "Doubt/Confusion", "Embarrassment", "Engagement", "Esteem",
    "Excitement", "Fatigue", "Fear", "Happiness", "Pain", "Peace",
    "Pleasure", "Sadness", "Sensitivity", "Suffering", "Surprise",
    "Sympathy", "Yearning",
)
CAT2IND: Dict[str, int] = {c: i for i, c in enumerate(EMOTIC_CATEGORIES)}
IND2CAT: Dict[int, str] = {i: c for i, c in enumerate(EMOTIC_CATEGORIES)}

# Emotic context/body normalization stats (Tandon-A/emotic conventions,
# matching the reference's context_norm/body_norm constructor args)
CONTEXT_NORM = ([0.4690646, 0.4407227, 0.40508908],
                [0.2514227, 0.24312855, 0.24266963])
BODY_NORM = ([0.43832874, 0.3964344, 0.3706214],
             [0.24784276, 0.23621225, 0.2323653])


def cat_to_one_hot(cats: Sequence[str]) -> np.ndarray:
    """26-dim one-hot over category names (mat2py.py:144-153)."""
    y = np.zeros((len(EMOTIC_CATEGORIES),), np.float32)
    for c in cats:
        y[CAT2IND[c]] = 1.0
    return y


@dataclasses.dataclass
class EmoticBatch:
    context: np.ndarray   # [B, 224, 224, 3] uint8
    body: np.ndarray      # [B, 128, 128, 3] uint8
    cat: np.ndarray       # [B, 26] float32 one-hot / soft labels
    cont: np.ndarray      # [B, 3] float32 (VAD / 10)
    valid: np.ndarray     # [B] bool

    @property
    def size(self) -> int:
        return self.context.shape[0]


def emotic_collate(items, batch_size: int, pad: bool) -> EmoticBatch:
    ctx = np.stack([it[0] for it in items])
    body = np.stack([it[1] for it in items])
    cat = np.stack([it[2] for it in items]).astype(np.float32)
    cont = np.stack([it[3] for it in items]).astype(np.float32)
    n = len(items)
    valid = np.ones((n,), bool)
    if pad and n < batch_size:
        reps = batch_size - n
        ctx = np.concatenate([ctx, np.repeat(ctx[-1:], reps, 0)])
        body = np.concatenate([body, np.repeat(body[-1:], reps, 0)])
        cat = np.concatenate([cat, np.repeat(cat[-1:], reps, 0)])
        cont = np.concatenate([cont, np.repeat(cont[-1:], reps, 0)])
        valid = np.concatenate([valid, np.zeros((reps,), bool)])
    return EmoticBatch(ctx, body, cat, cont, valid)


class EmoticPreDataset:
    """Preprocessed-npy variant (emotic.py:11-31): arrays in memory."""

    def __init__(self, x_context: np.ndarray, x_body: np.ndarray,
                 y_cat: np.ndarray, y_cont: np.ndarray):
        assert len(x_context) == len(x_body) == len(y_cat) == len(y_cont)
        self.x_context = x_context
        self.x_body = x_body
        self.y_cat = y_cat
        self.y_cont = y_cont

    @classmethod
    def from_dir(cls, save_dir: str, split: str = "train"
                 ) -> "EmoticPreDataset":
        load = lambda name: np.load(
            os.path.join(save_dir, f"{split}_{name}_arr.npy"))
        return cls(load("context"), load("body"), load("cat"), load("cont"))

    def __len__(self) -> int:
        return len(self.y_cat)

    def __getitem__(self, idx: int):
        return (np.asarray(self.x_context[idx], np.uint8),
                np.asarray(self.x_body[idx], np.uint8),
                np.asarray(self.y_cat[idx], np.float32),
                np.asarray(self.y_cont[idx], np.float32) / 10.0)


class EmoticCSVDataset:
    """CSV variant decoding rows at runtime (emotic.py:35-64)."""

    def __init__(self, data_df, data_src: str = "./"):
        self.df = data_df.reset_index(drop=True)
        self.data_src = data_src

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, idx: int):
        from PIL import Image

        row = self.df.loc[idx]
        img = Image.open(os.path.join(self.data_src, row["Folder"],
                                      row["Filename"])).convert("RGB")
        bbox = ast.literal_eval(str(row["BBox"]))
        body = img.crop((bbox[0], bbox[1], bbox[2], bbox[3]))
        context = np.asarray(img.resize((224, 224)), np.uint8)
        body = np.asarray(body.resize((128, 128)), np.uint8)
        cats = ast.literal_eval(str(row["Categorical_Labels"]))
        cont = np.asarray(ast.literal_eval(str(row["Continuous_Labels"])),
                          np.float32)
        return context, body, cat_to_one_hot(cats), cont / 10.0


def normalize_emotic_batch(context_u8, body_u8, dtype=torch.float32):
    """uint8 HWC -> NCHW float with the EMOTIC context/body stats, on the
    batch's device (replaces torchvision Normalize); numpy input is taken
    as CPU tensors."""
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch

    return (normalize_batch(torch.as_tensor(context_u8), *CONTEXT_NORM,
                            dtype=dtype),
            normalize_batch(torch.as_tensor(body_u8), *BODY_NORM,
                            dtype=dtype))
