"""The port's binding of the C++ batch image loader (data/native_loader.py,
built from the reference's unchanged native/loader.cpp into build/)
against the JAX package's binding on the same JPEGs, the dummy on a
corrupt or missing file, BatchLoader(native=True) against the
reference's, and the PIL fallback where the library cannot be built.

Both bindings load a library compiled from the same source; built with
the same flags (``-O3``, as here, where the largest difference measured
is 0) they decode identically. The reference's ``native/build.sh`` adds
``-march=native``, which may move a rounding: the bound is 1 level.
"""

import os

import numpy as np
import pytest

from vlm_clip_tpu.data import native_loader as RN
from vlm_clip_tpu.data import rafdb as RD
from vlm_clip_tpu_torch.data import native_loader as N
from vlm_clip_tpu_torch.data import rafdb as PD
from vlm_clip_tpu_torch.ops.build import BUILD_DIR

MAX_LEVELS = 1  # largest |port - reference| in uint8 levels


@pytest.fixture(autouse=True, scope="module")
def _native_builds():
    """Decided here, not at import: building the library starts g++."""
    if not (N.native_available() and RN.native_available()):
        pytest.skip(f"the native loader does not build here "
                    f"({N.unavailable_reason()})")


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    from PIL import Image

    from vlm_clip_tpu_torch.core.config import EMOTIONS

    root = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.default_rng(0)
    for e in EMOTIONS:
        d = root / e
        d.mkdir()
        for i in range(3):
            Image.fromarray(
                rng.integers(0, 255, (60 + 10 * i, 40, 3), dtype=np.uint8)
            ).save(d / f"{i}.jpg", quality=90)
    (root / "corrupt.jpg").write_bytes(b"\xff\xd8\xff not a whole jpeg")
    return root


def _same(a: np.ndarray, b: np.ndarray) -> None:
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= MAX_LEVELS, diff.max()


def test_builds_into_build_dir():
    """The library sits in build/ with the source's hash in its name."""
    path = N.library_path()
    assert os.path.dirname(path) == BUILD_DIR and os.path.isfile(path)
    assert os.path.basename(path).startswith("libvctloader-")
    assert N.unavailable_reason() is None


@pytest.mark.parametrize("size", [32, 64, 336])
def test_batch_decode_matches_reference(jpeg_tree, size):
    paths = [str(p) for p in sorted(jpeg_tree.glob("*/*.jpg"))]
    got, ok = N.load_batch_native(paths, size)
    want, ok_ref = RN.load_batch_native(paths, size)
    assert got.shape == (len(paths), size, size, 3) and got.dtype == np.uint8
    assert ok.all() and ok_ref.all()
    _same(got, want)


def test_batch_decode_and_dummy(jpeg_tree):
    """Missing and corrupt files: a black dummy and ok=False, both sides."""
    paths = [str(jpeg_tree / "angry" / "0.jpg"),
             str(jpeg_tree / "angry" / "1.jpg"),
             str(jpeg_tree / "nope.jpg"), str(jpeg_tree / "corrupt.jpg")]
    out, ok = N.load_batch_native(paths, 64)
    want, ok_ref = RN.load_batch_native(paths, 64)
    assert out.shape == (4, 64, 64, 3) and out.dtype == np.uint8
    assert list(ok) == list(ok_ref) == [True, True, False, False]
    assert out[2].sum() == 0 and out[3].sum() == 0
    assert out[0].std() > 0
    _same(out, want)


def test_close_to_pil(jpeg_tree):
    from vlm_clip_tpu_torch.data.preprocess import load_and_resize

    p = str(jpeg_tree / "happy" / "2.jpg")
    nat, ok = N.load_batch_native([p], 48)
    assert ok[0]
    ref = load_and_resize(p, 48)
    # bilinear vs bicubic on natural-ish content: same image, small diff
    diff = np.abs(nat[0].astype(int) - ref.astype(int)).mean()
    assert diff < 30, diff


def test_batchloader_native_path(jpeg_tree):
    """BatchLoader(native=True) yields the reference's native batches;
    an attached pixel cache takes precedence, as there."""
    ds = PD.FolderDataset(str(jpeg_tree), image_size=32)
    nat = PD.BatchLoader(ds, batch_size=8, native=True, shuffle=True,
                         seed=1)
    assert nat.native
    ref = RD.BatchLoader(RD.FolderDataset(str(jpeg_tree), image_size=32),
                         batch_size=8, native=True, shuffle=True, seed=1)
    assert ref.native
    nb, rb = list(nat), list(ref)
    assert len(nb) == len(rb) == 3
    for a, b in zip(nb, rb):
        _same(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.valid, b.valid)
        assert a.paths == b.paths
    plain = list(PD.BatchLoader(ds, batch_size=8, shuffle=True, seed=1))
    np.testing.assert_array_equal(nb[0].labels, plain[0].labels)
    assert nb[-1].valid.sum() == plain[-1].valid.sum() == 5

    from vlm_clip_tpu_torch.data.pixel_cache import PixelCache

    cached = PD.FolderDataset(str(jpeg_tree), image_size=32)
    pc = PixelCache.for_dataset(cached, str(jpeg_tree / "_cache"))
    assert not PD.BatchLoader(cached, batch_size=8, native=True).native
    np.testing.assert_array_equal(np.asarray(pc.pixels),
                                  N.load_batch_native(pc.paths, 32)[0])


def test_falls_back_to_pil_without_gxx(jpeg_tree, tmp_path, monkeypatch):
    """No g++: unavailable with the reason, no library written, and the
    loader and the pixel cache decode with PIL."""
    import shutil

    from vlm_clip_tpu_torch.data.pixel_cache import PixelCache
    from vlm_clip_tpu_torch.data.preprocess import load_and_resize

    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_reason", None)
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(N, "library_path",
                        lambda: str(tmp_path / "build" / "libvctloader.so"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not N.native_available()
    assert "g++" in N.unavailable_reason()
    assert not (tmp_path / "build").exists()
    with pytest.raises(RuntimeError, match="unavailable"):
        N.load_batch_native([str(jpeg_tree / "angry" / "0.jpg")], 32)
    ds = PD.FolderDataset(str(jpeg_tree), image_size=32)
    assert not PD.BatchLoader(ds, batch_size=8, native=True).native
    pc = PixelCache.build([ds.samples[0][0]], 32, str(tmp_path / "c"))
    np.testing.assert_array_equal(pc.get(0),
                                  load_and_resize(ds.samples[0][0], 32))
