"""The one traffic generator: every mix is a data file under
``traffic/`` whose parameters this module reads. Each seed gets the same
set of sizes and gaps, in another order, so a seed changes which request
comes when but not how much work a run holds."""

from __future__ import annotations

import json
import os

import numpy as np

from hb.common import BENCH_DIR


def load(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream per purpose, from the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def stratified_ints(n: int, lo: int, hi: int,
                    r: np.random.Generator) -> np.ndarray:
    """n integers spread evenly over [lo, hi] (the same multiset for
    every seed), in the seed's order."""
    vals = np.floor(lo + (hi - lo + 1) * (np.arange(n) + 0.5) / n)
    return r.permutation(np.clip(vals, lo, hi).astype(np.int64))


def images(n: int, size: int, r: np.random.Generator) -> np.ndarray:
    """n random RGB uint8 images [n, size, size, 3]."""
    return r.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def captions(n: int, lo: int, hi: int, pad_to: int, vocab: int, bos: int,
             eos: int, r: np.random.Generator):
    """(ids [n, pad_to] int64, mask [n, pad_to] int32): BOS, random word
    ids, EOS, then EOS padding with the mask at 0; lengths (BOS and EOS
    counted) spread evenly over [lo, hi]."""
    lens = stratified_ints(n, lo, hi, r)
    ids = np.full((n, pad_to), eos, np.int64)
    words = r.integers(1, min(bos, vocab) - 1, (n, pad_to), dtype=np.int64)
    mask = np.zeros((n, pad_to), np.int32)
    for i, k in enumerate(lens):
        ids[i, 0] = bos
        ids[i, 1:k - 1] = words[i, 1:k - 1]
        ids[i, k - 1] = eos
        mask[i, :k] = 1
    return ids, mask


