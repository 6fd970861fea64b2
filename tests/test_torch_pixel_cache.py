"""The port's decoded-uint8 pixel cache (data/pixel_cache.py), its
attachment to the RAF-DB datasets and the cached batch path of
BatchLoader, plus data/device_prefetch, against the JAX package's on a
tiny tree (CPU). Pixels are uint8 and decoded by the same PIL code, so
every comparison is exact."""

import json
import os

import numpy as np
import pytest
import torch

from vlm_clip_tpu.data import device_prefetch as RDP
from vlm_clip_tpu.data import rafdb as RD
from vlm_clip_tpu.data.pixel_cache import PixelCache as RPixelCache
from vlm_clip_tpu.data.tokenizer import HashTokenizer as RHash
from vlm_clip_tpu_torch.core.config import EMOTIONS
from vlm_clip_tpu_torch.data import device_prefetch as PDP
from vlm_clip_tpu_torch.data import rafdb as PD
from vlm_clip_tpu_torch.data.pixel_cache import PixelCache
from vlm_clip_tpu_torch.data.preprocess import load_and_resize
from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer as PHash

from helpers import VOCAB


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pxc")
    rng = np.random.default_rng(3)
    for e in EMOTIONS[:3]:
        d = root / e
        d.mkdir()
        for i in range(3):
            arr = rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{e}_{i}.jpg")
    # one corrupt file -> black dummy + ok=False
    (root / EMOTIONS[0] / "bad.jpg").write_bytes(b"not a jpeg")
    return root


@pytest.fixture(scope="module")
def m_tree(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pxc_m")
    rng = np.random.default_rng(4)
    for e in EMOTIONS:
        d = root / "train" / e
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (36, 44, 3),
                                         dtype=np.uint8)).save(
                d / f"{e}_{i}.jpg")
    return str(root)


def test_build_open_and_fallbacks(tree, tmp_path):
    """Build, reopen without a rebuild, rebuild on another size; the
    corrupt file is a black dummy with ok=False; the pixels, ok mask and
    manifest equal the reference's, and each package opens the other's
    cache."""
    ds = PD.FolderDataset(str(tree), image_size=24)
    pc = PixelCache.for_dataset(ds, str(tmp_path / "cache"),
                                use_native=False)
    ref = RPixelCache.for_dataset(RD.FolderDataset(str(tree), image_size=24),
                                  str(tmp_path / "ref"), use_native=False)
    assert len(pc) == len(ds) == len(ref)
    np.testing.assert_array_equal(np.asarray(pc.pixels),
                                  np.asarray(ref.pixels))
    np.testing.assert_array_equal(pc.ok, ref.ok)
    assert pc.paths == ref.paths
    bad = [i for i, (p, _) in enumerate(ds.samples) if "bad" in p]
    assert len(bad) == 1 and not pc.ok[bad[0]]
    assert (pc.get(bad[0]) == 0).all()
    for i in range(len(ds)):
        if pc.ok[i]:
            np.testing.assert_array_equal(
                pc.get(i), load_and_resize(ds.samples[i][0], 24))
    with open(tmp_path / "cache" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "ref" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine == theirs
    np.testing.assert_array_equal(
        np.asarray(RPixelCache.open(str(tmp_path / "cache")).pixels),
        np.asarray(PixelCache.open(str(tmp_path / "ref")).pixels))
    # reopen (no rebuild) keeps alignment; mismatched size rebuilds
    mtime = os.stat(tmp_path / "cache" / "pixels.npy").st_mtime_ns
    pc2 = PixelCache.build([s[0] for s in ds.samples], 24,
                           str(tmp_path / "cache"), use_native=False)
    assert os.stat(tmp_path / "cache" / "pixels.npy").st_mtime_ns == mtime
    np.testing.assert_array_equal(pc2.get(0), pc.get(0))
    pc3 = PixelCache.build([s[0] for s in ds.samples], 16,
                           str(tmp_path / "cache"), use_native=False)
    assert pc3.image_size == 16 and pc3.pixels.shape[1:] == (16, 16, 3)


def test_rebuild_on_a_changed_source(tree, tmp_path):
    """An in-place edit of a source image (same name, new fingerprint)
    rebuilds the cache, as in the reference."""
    from PIL import Image

    src = tmp_path / "src"
    src.mkdir()
    paths = []
    for i in range(3):
        p = src / f"{i}.jpg"
        Image.fromarray(np.full((30, 30, 3), 40 * i, np.uint8)).save(p)
        paths.append(str(p))
    pc = PixelCache.build(paths, 16, str(tmp_path / "c"), use_native=False)
    assert int(pc.get(1).mean()) == pytest.approx(40, abs=2)
    Image.fromarray(np.full((30, 30, 3), 200, np.uint8)).save(paths[1])
    os.utime(paths[1], ns=(1, 1))  # a fingerprint that surely differs
    pc = PixelCache.build(paths, 16, str(tmp_path / "c"), use_native=False)
    assert int(pc.get(1).mean()) == pytest.approx(200, abs=2)
    ref = RPixelCache.build(paths, 16, str(tmp_path / "c"),
                            use_native=False)  # the reference reopens it
    np.testing.assert_array_equal(np.asarray(ref.pixels),
                                  np.asarray(pc.pixels))


def test_attach_validates(tree, tmp_path):
    ds = PD.FolderDataset(str(tree), image_size=24)
    other = PD.FolderDataset(str(tree), image_size=16)
    pc = PixelCache.for_dataset(ds, str(tmp_path / "c2"), use_native=False)
    with pytest.raises(ValueError, match="does not match"):
        other.attach_pixel_cache(pc)
    short = PixelCache(pc.pixels[:3], pc.paths[:3], pc.ok[:3], 24)
    with pytest.raises(ValueError, match="does not match"):
        ds.attach_pixel_cache(short)


def test_loader_cached_batches_match_decode(tree, tmp_path):
    """Cached batches equal decoded ones bit for bit, and equal the
    reference loader's over its own cache (padding and labels too)."""
    ds_plain = PD.FolderDataset(str(tree), image_size=24)
    ds_cached = PD.FolderDataset(str(tree), image_size=24)
    PixelCache.for_dataset(ds_cached, str(tmp_path / "c3"),
                           use_native=False)
    ds_ref = RD.FolderDataset(str(tree), image_size=24)
    RPixelCache.for_dataset(ds_ref, str(tmp_path / "c3r"), use_native=False)
    kw = dict(batch_size=4, shuffle=True, pad_final=True, seed=5)
    plain = list(PD.BatchLoader(ds_plain, **kw))
    cached = list(PD.BatchLoader(ds_cached, **kw))
    ref = list(RD.BatchLoader(ds_ref, **kw))
    assert len(plain) == len(cached) == len(ref) == 3
    for a, b, c in zip(plain, cached, ref):
        for f in ("images", "labels", "valid", "indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(b, f), getattr(c, f))
        assert b.paths == c.paths


def test_rafdb_cached_batches_match_reference(m_tree, tmp_path):
    """The M-style dataset's batched cache read (get_batch: one mmap
    slice, one tokenizer call) equals the reference's, captions and
    token ids included, and equals the decoded path's pixels."""
    pds = PD.RAFDBDataset(m_tree, "train", PHash(VOCAB), image_size=32)
    rds = RD.RAFDBDataset(m_tree, "train", RHash(VOCAB), image_size=32)
    plain = PD.RAFDBDataset(m_tree, "train", PHash(VOCAB), image_size=32)
    PixelCache.for_dataset(pds, str(tmp_path / "p"), use_native=False)
    RPixelCache.for_dataset(rds, str(tmp_path / "r"), use_native=False)
    kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=2)
    for a, b, c in zip(PD.BatchLoader(pds, **kw), RD.BatchLoader(rds, **kw),
                       PD.BatchLoader(plain, **kw)):
        for f in ("images", "labels", "input_ids", "attention_mask",
                  "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.captions == b.captions
        np.testing.assert_array_equal(a.images, c.images)


def test_prefetch_to_device_matches_reference():
    """Items come out in order with the same values as the reference's
    prefetch, ``size`` ahead; the transform applies; with a mesh each
    rank copies its rows of the data axis."""
    items = [{"a": np.arange(6, dtype=np.int32).reshape(2, 3) + i,
              "b": [np.full((2,), i, np.float32)]} for i in range(5)]
    for size in (0, 1, 2, 4):
        got = list(PDP.prefetch_to_device(iter(items), size=size,
                                          device="cpu"))
        want = list(RDP.prefetch_to_device(iter(items), size=size))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert isinstance(g["a"], torch.Tensor)
            np.testing.assert_array_equal(g["a"].numpy(), np.asarray(w["a"]))
            np.testing.assert_array_equal(g["b"][0].numpy(),
                                          np.asarray(w["b"][0]))
    seen = []

    def pulled():
        for i, it in enumerate(items):
            seen.append(i)
            yield it

    first = next(PDP.prefetch_to_device(pulled(), size=3, device="cpu",
                                        transform=lambda it: it["a"]))
    assert seen == [0, 1, 2] and first.shape == (2, 3)
    # with a mesh, rank r of a data axis of size w copies its rows
    rank1 = _RankOfMesh(rank=1, data=2)
    got = next(PDP.prefetch_to_device(iter(items), mesh=rank1,
                                      device="cpu"))
    np.testing.assert_array_equal(got["a"].numpy(), items[0]["a"][1:2])
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  items[0]["b"][0][1:2])
    with pytest.raises(ValueError, match="do not divide"):
        next(PDP.prefetch_to_device(iter(items), device="cpu",
                                    mesh=_RankOfMesh(rank=0, data=4)))


class _RankOfMesh:
    """What prefetch_to_device reads of a ('data', 'model') device mesh
    on one rank: its index along data and the axes' sizes."""

    mesh_dim_names = ("data", "model")

    def __init__(self, rank: int, data: int):
        self.rank, self.data = rank, data

    def get_local_rank(self, axis):
        return self.rank if axis == "data" else 0

    def size(self, dim):
        return (self.data, 1)[dim]
