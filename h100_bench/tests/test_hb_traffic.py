"""The traffic generator is seeded and deterministic, and every seed
gets the same sizes in another order."""

import numpy as np

from hb import traffic as TR


def test_budgets_and_caption_lengths_stratified():
    b1 = TR.stratified_ints(1024, 25, 200, TR.rng(5, 3))
    b2 = TR.stratified_ints(1024, 25, 200, TR.rng(6, 3))
    assert np.array_equal(np.sort(b1), np.sort(b2))
    assert not np.array_equal(b1, b2)
    assert b1.min() == 25 and b1.max() == 200
    assert abs(b1.mean() - 112.5) < 0.5
    ids, mask = TR.captions(384, 8, 77, 77, 49408, 49406, 49407,
                            TR.rng(5, 1))
    ids2, mask2 = TR.captions(384, 8, 77, 77, 49408, 49406, 49407,
                              TR.rng(5, 1))
    assert np.array_equal(ids, ids2) and np.array_equal(mask, mask2)
    lens = mask.sum(1)
    assert lens.min() == 8 and lens.max() == 77
    for row, k in zip(ids, lens):
        assert row[0] == 49406 and row[k - 1] == 49407
        assert (row[k:] == 49407).all() and (row[1:k - 1] < 49406).all()


def test_images_seeded():
    a = TR.images(2, 448, TR.rng(9, 4))
    assert a.shape == (2, 448, 448, 3) and a.dtype == np.uint8
    assert np.array_equal(a, TR.images(2, 448, TR.rng(9, 4)))
