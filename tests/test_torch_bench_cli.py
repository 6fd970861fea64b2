"""BASELINE configs 4 and 5 end to end on the CPU: the port's
cli/bench_video and cli/bench_label_finetune with ``--device cpu`` at
the tiny config (the presets swapped for it in both packages: the CLIs'
paths are under test here), beside the JAX package's runs of the same
CLIs with the same arguments.

- bench_label_finetune: the synthetic tree is byte for byte the
  reference's; the labels jsonl (stub captions of the natively decoded
  images) and the pixel cache at the config's size equal the
  reference's exactly (the same C++ decoder, the same stub); both print
  the same lines; the port's losses are finite and its step count is
  epochs x steps + 1 + the timed steps.
- bench_video: both print the same lines (demux, chip only,
  device-resident, serial, overlapped, reference pattern, sanity), the
  rates are positive, and ``--no-demux`` (no cv2) prints the chip-only
  and device-resident lines alone.
"""

import json
import math
import os

import numpy as np
import pytest

from vlm_clip_tpu_torch.data import native_loader

from _torch_port import port_clip_config
from helpers import tiny_clip_config


def _line_heads(text: str):
    """The label before the first ':' of each printed line that has one."""
    return [ln.split(":")[0].strip() for ln in text.splitlines()
            if ":" in ln and not ln.startswith(" ")]


@pytest.fixture
def tiny_presets(monkeypatch):
    from vlm_clip_tpu.cli import common as rcommon
    from vlm_clip_tpu.core import config as rconfig
    from vlm_clip_tpu_torch.cli import common
    from vlm_clip_tpu_torch.core import config

    monkeypatch.setattr(rcommon, "clip_preset",
                        lambda name: tiny_clip_config())
    monkeypatch.setattr(rconfig, "clip_preset",
                        lambda name: tiny_clip_config())
    monkeypatch.setattr(common, "clip_preset",
                        lambda name: port_clip_config(tiny_clip_config()))
    monkeypatch.setattr(config, "clip_preset",
                        lambda name: port_clip_config(tiny_clip_config()))


def test_bench_label_finetune_cpu(tiny_presets, tmp_path, capsys):
    if not native_loader.native_available():
        pytest.skip(f"the native loader does not build here "
                    f"({native_loader.unavailable_reason()})")
    from vlm_clip_tpu.cli import bench_label_finetune as ref
    from vlm_clip_tpu.data.pixel_cache import PixelCache as RPixelCache
    from vlm_clip_tpu_torch.cli import bench_label_finetune as B
    from vlm_clip_tpu_torch.data.pixel_cache import PixelCache

    n = B.synth_tree(str(tmp_path / "tree"), 2, 48)
    ref.synth_tree(str(tmp_path / "ref_tree"), 2, 48)
    for d, _, files in os.walk(tmp_path / "tree"):
        for f in files:
            with open(os.path.join(d, f), "rb") as a, open(os.path.join(
                    str(d).replace("tree", "ref_tree"), f), "rb") as b:
                assert a.read() == b.read()
    assert n == 14
    argv = ["--data-root", str(tmp_path / "tree"), "--batch", "4",
            "--epochs", "2"]
    capsys.readouterr()
    out = B.main(argv + ["--tmpdir", str(tmp_path / "port"),
                         "--device", "cpu"])
    port_text = capsys.readouterr().out
    (tmp_path / "ref").mkdir()  # the reference makes it only with a tree
    ref.main(argv + ["--tmpdir", str(tmp_path / "ref")])
    ref_text = capsys.readouterr().out
    assert _line_heads(port_text) == _line_heads(ref_text)
    assert "native decoder" in port_text

    rows = [[json.loads(ln) for ln in open(tmp_path / d / "labels.jsonl")]
            for d in ("port", "ref")]
    assert rows[0] == rows[1] and len(rows[0]) == 14
    assert all(r["caption"] for r in rows[0])
    mine = PixelCache.open(str(tmp_path / "port" / "pixcache32"))
    theirs = RPixelCache.open(str(tmp_path / "ref" / "pixcache32"))
    np.testing.assert_array_equal(np.asarray(mine.pixels),
                                  np.asarray(theirs.pixels))
    assert mine.paths == theirs.paths and mine.ok.all()

    assert out["steps"] == 2 * (14 // 4) + 1 + B.RESIDENT_STEPS
    assert len(out["epoch_pairs_per_s"]) == 2
    assert all(math.isfinite(v) for v in out["losses"])
    assert out["step_ms"] > 0 and out["cache_mb"] == pytest.approx(
        14 * 32 * 32 * 3 / 1e6)
    assert out["trainer"].state.step == out["steps"]
    assert tuple(out["batch"]["pixel_values"].shape) == (4, 3, 32, 32)


def test_bench_video_cpu(tiny_presets, tmp_path, capsys):
    pytest.importorskip("cv2")
    from vlm_clip_tpu.cli import bench_video as ref
    from vlm_clip_tpu_torch.cli import bench_video as BV

    argv = ["--frames", "16", "--batch", "8", "--width", "80",
            "--height", "64", "--size", "32"]
    capsys.readouterr()
    out = BV.main(argv + ["--tmpdir", str(tmp_path / "p"), "--device",
                          "cpu"])
    port_text = capsys.readouterr().out
    (tmp_path / "r").mkdir()
    ref.main(argv + ["--tmpdir", str(tmp_path / "r")])
    ref_text = capsys.readouterr().out
    assert _line_heads(port_text) == _line_heads(ref_text)
    assert set(out) == {"demux", "chip_only", "device_resident",
                        "e2e_serial", "e2e_overlapped", "reference_pattern"}
    assert all(v > 0 for v in out.values())

    out = BV.main(["--no-demux", "--frames", "8", "--batch", "4",
                   "--size", "32", "--device", "cpu"])
    text = capsys.readouterr().out
    assert set(out) == {"chip_only", "device_resident"}
    assert _line_heads(text) == ["frames", "chip only", "device-resident",
                                 "sanity"]
