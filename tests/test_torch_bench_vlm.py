"""The VLM serving benches of vlm_clip_tpu_torch.cli (bench_vision,
bench_context, bench_engine, bench_spec) at tiny shapes on the CPU, their
3B config patched to a tiny one; bench_spec's hermetic half against the
JAX package's; and the import rule of the serving slice's modules."""

import subprocess
import sys

import pytest
import torch

from vlm_clip_tpu_torch.vlm import qwen_model as PM

NEW_MODULES = ("vlm_clip_tpu_torch.vlm.engine",
               "vlm_clip_tpu_torch.vlm.speculative",
               "vlm_clip_tpu_torch.cli.serve_vlm",
               "vlm_clip_tpu_torch.cli.bench_engine",
               "vlm_clip_tpu_torch.cli.bench_spec",
               "vlm_clip_tpu_torch.cli.bench_context",
               "vlm_clip_tpu_torch.cli.bench_vision")


def tiny_3b():
    """A stand-in for qwen25vl_3b: two text layers of 64, a two-layer
    vision tower of width 32 with the 3B's patch and window sizes (so 448
    pixels still give 256 vision tokens), a vocabulary that holds the
    benches' random prompt ids (1..9999) below the special tokens."""
    return PM.QwenVLConfig(
        text=PM.QwenTextConfig(
            hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=10240,
            mrope_section=(2, 3, 3)),
        vision=PM.QwenVisionConfig(
            hidden_size=32, intermediate_size=64, out_hidden_size=64,
            depth=2, num_heads=2, fullatt_block_indexes=(1,)),
        image_token_id=10100, vision_start_token_id=10099,
        eos_token_id=10101)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(PM, "qwen25vl_3b", tiny_3b)
    return tiny_3b()


def bench_main(name, argv, **kw):
    import importlib

    return importlib.import_module(
        f"vlm_clip_tpu_torch.cli.{name}").main(argv, **kw)


def test_bench_vision_on_cpu(tiny, capsys):
    res = bench_main("bench_vision", ["--batch", "2", "--size", "56",
                                      "--reps", "1", "--device", "cpu"])
    assert res["shape"] == (2, 4, 64) and res["finite"]
    res = bench_main("bench_vision", ["--size", "56", "--reps", "1",
                                      "--path", "masked", "--quant", "int8",
                                      "--dtype", "bf16", "--device", "cpu"])
    assert res["shape"] == (1, 4, 64) and res["finite"]
    out = capsys.readouterr().out
    assert "ms/image" in out and "path=masked" in out


def test_bench_context_on_cpu(tiny, capsys):
    res = bench_main("bench_context", ["--batch", "2", "--new", "4",
                                       "--size", "56", "--max-len", "64",
                                       "--reps", "1", "--device", "cpu"])
    assert len(res["tokens"]) == 2 and res["s_per_image"] > 0
    res = bench_main("bench_context", ["--new", "3", "--size", "56",
                                       "--max-len", "64", "--reps", "1",
                                       "--u8", "--kv-bits", "8",
                                       "--bits", "mixed", "--device", "cpu"])
    assert len(res["tokens"]) == 1
    assert "contexts/hour" in capsys.readouterr().out


def test_bench_engine_on_cpu(tiny, capsys):
    """Mixed budgets and one Poisson rate: the engine's tokens equal the
    static batches' (greedy), row by row."""
    res = bench_main("bench_engine", [
        "--slots", "2", "--requests", "5", "--budget-lo", "2",
        "--budget-hi", "7", "--size", "56", "--max-len", "64",
        "--refill-chunks", "2,1", "--sync-steps", "2", "--arrivals",
        "1000", "--device", "cpu"])
    rids = sorted(res["engine_results"])
    assert [res["engine_results"][r] for r in rids] == res["static_results"]
    assert res["engine_tokens"] == res["static_tokens"] > 0
    assert len(res["arrivals"]) == 1
    row = res["arrivals"][0]
    assert 0 <= row["engine_ttft_p50"] <= row["engine_ttft_p95"]
    out = capsys.readouterr().out
    for line in ("engine:", "static:", "engine speedup", "engine λ=",
                 "static λ="):
        assert line in out, line


def test_benches_default_to_the_card(tiny, monkeypatch):
    """Without --device every bench runs on the card, and raises without
    one rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("bench_engine", []), ("bench_context", []),
                       ("bench_vision", []),
                       ("bench_spec", ["--device", "cuda"])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            bench_main(name, argv)


def test_bench_spec_round_cost_on_cpu(tiny, capsys):
    res = bench_main("bench_spec", ["--device", "cpu", "--slots", "2",
                                    "--requests", "2", "--budget", "4"])
    v, s = res["round_ms"][2]
    assert v > 0 and s > 0
    out = capsys.readouterr().out
    assert "slots=2 spec_k=4" in out and "| 2 |" in out


def test_bench_spec_hermetic_half_matches_reference(capsys):
    """The oracle acceptance walks equal the reference's on the same
    word streams (plain, prompt-seeded re-description and paraphrase),
    and the hermetic half prints the reference's table."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vlm_clip_tpu.cli import bench_spec as R
    from vlm_clip_tpu_torch.cli import bench_spec as P
    from vlm_clip_tpu_torch.vlm.extractor import VLM_PROMPT

    assert P.CORPUS == R.CORPUS
    toks, _ = P.word_tokens(P.CORPUS[0])
    assert toks == R.word_tokens(R.CORPUS[0])[0]
    assert P.oracle_acceptance(toks, 2) == R.oracle_acceptance(toks, 2)
    for ptxt in (VLM_PROMPT + " " + P.CORPUS[0],
                 VLM_PROMPT + " " + P.CORPUS[2]):
        tk, _ = P.word_tokens(ptxt + " \x00 " + P.CORPUS[0])
        plen = len(ptxt.split()) + 1
        got = P.oracle_acceptance(tk[plen:], 4, prompt=tk[:plen])
        assert got == R.oracle_acceptance(tk[plen:], 4, prompt=tk[:plen])
    out = P.main([])
    assert set(out["k"]) == {2, 4, 8} and out["seeded"]["re-describe"] > 1
    printed = capsys.readouterr().out
    for line in ("K=4 over one concatenated long stream", "instruction",
                 "paraphrase", "re-describe"):
        assert line in printed, line


def test_new_modules_import_no_jax():
    """The serving slice's modules import torch and never jax or the JAX
    package (a fresh interpreter, so nothing else has imported them)."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in NEW_MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'vlm_clip_tpu' or "
              "m.startswith('vlm_clip_tpu.'))\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
