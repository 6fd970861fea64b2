"""vlm_clip_tpu_torch.ops.build on the CPU, with a stand-in compiler: the
parallel build reads every compiler's output to the end (more than a pipe
holds), records each one's time and raises on a failed build; a library's
name changes with its source and with every header under csrc/."""

import os
import sys
import threading

import pytest

from vlm_clip_tpu_torch.ops import build

CHATTY = 200_000  # bytes each stand-in compiler prints, over 3 pipe buffers


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A compiler that prints CHATTY bytes, then fails on sources named
    bad*.cu and writes its -o file for the others."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        f"sys.stdout.write('ptxas info: Used 32 registers\\n' * "
        f"({CHATTY} // 30 + 1))\n"
        "sys.stdout.flush()\n"
        "if 'bad' in args[-1].rsplit('/', 1)[-1]:\n"
        "    sys.exit(3)\n"
        "open(args[args.index('-o') + 1], 'w').write('not a library')\n")
    script.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("good", "bad"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_logs", {})
    monkeypatch.setattr(build, "build_seconds", {})
    return tmp_path


def _load_within(names, seconds=60):
    """load_libraries(names) in a thread: (the exception it raised, whether
    it finished within ``seconds``)."""
    raised = []

    def go():
        try:
            build.load_libraries(names)
        except BaseException as e:  # noqa: BLE001 - handed to the test
            raised.append(e)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(seconds)
    return (raised[0] if raised else None), not t.is_alive()


@pytest.mark.parametrize("names", [["bad"], ["good", "bad"]])
def test_failed_build_raises_after_reading_all_output(fake_nvcc, names):
    err, finished = _load_within(names)
    assert finished, "load_libraries hung on a compiler's full pipe"
    assert isinstance(err, RuntimeError)
    assert "nvcc failed building" in str(err) and "exit 3" in str(err)
    assert set(build.build_seconds) == set(names)
    for name in names:
        assert len(build.build_logs[name]) >= CHATTY
    assert not any(f.startswith("libbad-") and f.endswith(".so")
                   for f in os.listdir(build.BUILD_DIR))


def test_successful_build_keeps_its_output(fake_nvcc):
    """A build that succeeds lands at its hashed name (the stand-in
    writes no real library, so loading it fails afterwards)."""
    err, finished = _load_within(["good"])
    assert finished
    assert isinstance(err, OSError)  # ctypes could not load the stand-in
    assert os.path.isfile(build._out_path("good"))
    assert len(build.build_logs["good"]) >= CHATTY
    assert build.build_seconds["good"] >= 0.0


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    """An edit to a header under csrc/ (which any source may include)
    renames every library, as an edit to the source renames its own, so a
    stale build is never loaded; other files do not count."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f'#include "mma.cuh"\n// {name}\n')
    (csrc / "mma.cuh").write_text("// helpers v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    first = {n: build._out_path(n) for n in ("a", "b")}
    assert first["a"] != first["b"]
    assert all(os.path.basename(p).startswith(f"lib{n}-")
               for n, p in first.items())
    (csrc / "notes.txt").write_text("not a header\n")
    assert {n: build._out_path(n) for n in ("a", "b")} == first
    (csrc / "mma.cuh").write_text("// helpers v2\n")
    second = {n: build._out_path(n) for n in ("a", "b")}
    assert all(second[n] != first[n] for n in ("a", "b"))
    (csrc / "extra.cuh").write_text("// a new header\n")
    third = {n: build._out_path(n) for n in ("a", "b")}
    assert all(third[n] != second[n] for n in ("a", "b"))
    (csrc / "a.cu").write_text("// a, edited\n")
    assert build._out_path("a") != third["a"]
    assert build._out_path("b") == third["b"]


def test_aligned16_copies_only_views_off_a_16_byte_boundary():
    import torch

    base = torch.arange(64, dtype=torch.bfloat16)
    assert build.aligned16(base).data_ptr() == base.data_ptr()
    view = base[3:35]  # starts 6 bytes past an aligned start
    got = build.aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.data_ptr() != view.data_ptr()
    assert torch.equal(got, view)
    strided = base.view(8, 8)[:, :4]
    got = build.aligned16(strided)
    assert got.is_contiguous() and torch.equal(got, strided)
    assert got.data_ptr() % 16 == 0
