"""cli/validate_parity in the port: the hermetic four-leg run, the
--append block, the eval legs against the JAX harness's on the same
fixtures, a checkpoint directory through --clip (the port's own loader;
its vocab picked up, the hash tokenizer refused), and the error a logit
leg gives without transformers.

Tolerances: the logit legs at the harness's own --tol (5e-3; the port
and HF's torch model agree far closer, see test_torch_convert_hf.py);
zero-shot accuracy exactly and EMOTIC mAP within 1e-6 of the JAX
harness's on the same weights and images.
"""

import sys

import pytest

from vlm_clip_tpu.cli import validate_parity as RVP
from vlm_clip_tpu.data.tokenizer import HashTokenizer as RHash
from vlm_clip_tpu_torch.cli import validate_parity as VP
from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer


def test_tiny_fixture_passes_all_four_legs(capsys):
    rc = VP.main(["--tiny-fixture", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("PASS") == 4 and "FAIL" not in out
    assert "rafdb-zeroshot(tiny-fixture)" in out
    assert "emotic-mAP(tiny-fixture)" in out and '"mAP"' in out


def test_append_writes_its_block(tmp_path):
    md = tmp_path / "results.md"
    assert VP.main(["--tiny-fixture", "--device", "cpu", "--append",
                    str(md)]) == 0
    text = md.read_text()
    assert "Parity validation" in text and "logits_per_image" in text
    assert "text_logits" in text and "emotic-mAP(tiny-fixture)" in text


def test_eval_legs_match_the_jax_harness(tmp_path, monkeypatch):
    """The same tiny HF CLIP (the harness's seed) converted by each
    package, the same generated RAF-DB tree and EMOTIC arrays. The
    zero-shot leg runs at FP32 in both harnesses; the EMOTIC leg scores
    under the packages' default BF16 policy, whose rounding the two
    implementations do not share, so both packages' BF16 is patched to
    their FP32 for the comparison."""
    from vlm_clip_tpu.core import dtypes as RDT
    from vlm_clip_tpu_torch.core import dtypes as PDT

    monkeypatch.setattr(RDT, "BF16", RDT.FP32)
    monkeypatch.setattr(PDT, "BF16", PDT.FP32)
    _, rparams, rcfg = RVP._tiny_hf_clip()
    _, pparams, pcfg = VP._tiny_hf_clip("cpu")
    rafdb, emotic = str(tmp_path / "rafdb"), str(tmp_path / "emotic")
    VP._fixture_rafdb_tree(rafdb, pcfg.vision.image_size, per_class=3)
    VP._fixture_emotic_npy(emotic, pcfg.vision.image_size, n=20)
    got = VP.zero_shot_rafdb(pparams, pcfg, rafdb,
                             HashTokenizer(pcfg.text.vocab_size))
    want = RVP.zero_shot_rafdb(rparams, rcfg, rafdb,
                               RHash(rcfg.text.vocab_size))
    assert got == want and got["num_images"] == 21
    got = VP.emotic_map(pparams, pcfg, emotic,
                        HashTokenizer(pcfg.text.vocab_size))
    want = RVP.emotic_map(rparams, rcfg, emotic, RHash(rcfg.text.vocab_size))
    assert got["num_samples"] == want["num_samples"] == 20
    assert abs(got["mAP"] - want["mAP"]) <= 1e-6


@pytest.fixture
def ckpt_dir(tmp_path, monkeypatch):
    """The harness's tiny HF CLIP saved as a checkpoint directory."""
    from vlm_clip_tpu_torch.data import tokenizer as T

    hf, _, cfg = VP._tiny_hf_clip("cpu")
    d = tmp_path / "clip"
    hf.save_pretrained(str(d))
    monkeypatch.setattr(T, "ASSET_DIR", str(tmp_path / "no_assets"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hub"))
    rafdb, emotic = str(tmp_path / "rafdb"), str(tmp_path / "emotic")
    VP._fixture_rafdb_tree(rafdb, cfg.vision.image_size)
    VP._fixture_emotic_npy(emotic, cfg.vision.image_size)
    return str(d), ["--rafdb", rafdb, "--emotic-npy", emotic, "--device",
                    "cpu"]


def test_clip_dir_runs_every_leg_and_refuses_hash_tokens(ckpt_dir, capsys):
    """--clip DIR: the logit leg and both eval legs on the directory
    loaded by the port's own loader; with real weights and no vocab the
    eval legs refuse hash ids unless --allow-hash-tokenizer (the vocab
    pickup itself: test_torch_convert_hf.py)."""
    d, legs = ckpt_dir
    with pytest.raises(RuntimeError, match="hash"):
        VP.main(["--clip", d] + legs)
    assert VP.main(["--clip", d, "--allow-hash-tokenizer"] + legs) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == 3 and "FAIL" not in out
    assert '"tokenizer_degraded": true' in out and '"mAP"' in out


def test_logit_legs_name_the_missing_package(ckpt_dir, monkeypatch):
    """Without transformers the logit legs raise an error that names it;
    --eval-only runs the eval legs without it."""
    d, legs = ckpt_dir
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        VP.main(["--tiny-fixture", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="transformers"):
        VP.main(["--clip", d, "--allow-hash-tokenizer"] + legs)
    assert VP.main(["--clip", d, "--allow-hash-tokenizer",
                    "--eval-only"] + legs) == 0
