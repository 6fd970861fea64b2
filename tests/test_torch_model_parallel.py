"""The port's model parallelism across two real processes (gloo on the
CPU, localhost): the engine's mesh, PipelineGenerator, the sharded video
scorer and ``serve_vlm --tp 2``, held against the JAX package in one
process.

The parent makes the params (the reference's init, bridged), computes
the reference's results and starts two ``tests/_torch_mp_worker.py``
ranks (scenario ``model``); it never brings a process group up, and the
workers import no jax. The reference's meshes (tests/test_engine.py,
tests/test_pipeline_parallel.py, tests/test_emotic_video.py) shrink to
two ranks:

- the engine at tp 2 (fp, and NF4 bridged from the reference's
  quantizer) and at dp 2: greedy tokens equal to the JAX single-device
  engine's; speculative sampled runs at tp 2 and dp 2 stay in the
  vocabulary and their budgets; 3 slots over dp 2 refuse;
- PipelineGenerator at 2 stages (the reference's 4): greedy tokens and
  a repetition penalty's equal to the JAX uncached oracle's, an early
  eos trimmed where the oracle stops, a seeded sampled run valid and
  repeatable, and the bad-shape refusals;
- score_video_frames_sharded at seq 2 against the JAX single-device
  scorer, atol 2e-5;
- ``serve_vlm --tp 2`` on a tiny stand-in for the 3B config: two HTTP
  requests answered with a single-process engine's tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (port_clip_config, port_qwen_config, run_ranks,
                         to_torch)
from helpers import tiny_clip_config
from test_engine import VOCAB, _requests, tiny_cfgs
from test_pipeline_parallel import (greedy_oracle, greedy_oracle_penalty,
                                    tiny_text_cfg)
from vlm_clip_tpu.core.dtypes import FP32
from vlm_clip_tpu.data import video as RV
from vlm_clip_tpu.models.clip import init_clip
from vlm_clip_tpu.vlm import qwen_convert as RC
from vlm_clip_tpu.vlm import qwen_model as RM
from vlm_clip_tpu.vlm.engine import ContinuousBatchingEngine as REngine
from vlm_clip_tpu.vlm.qwen import QwenVLGenerator as RGen

EOS = 7
SAMPLED = {"do_sample": True, "temperature": 1.1, "top_k": 8,
           "top_p": 0.95, "repetition_penalty": 1.05}


def _jax_engine(params, cfg, ids, visions, budgets):
    eng = REngine(RGen(params, cfg, max_len=96, dtype=jnp.float32),
                  n_slots=2, sync_steps=3, refill_chunks=(2, 1))
    rids = [eng.submit(ids, v, max_new_tokens=m)
            for v, m in zip(visions, budgets)]
    got = eng.flush()
    return [got[r] for r in rids]


def _case(name, mesh, ids, visions, budgets, **kw):
    return dict(name=name, mesh=mesh, n_slots=2, sync=3, refill=(2, 1),
                ids=ids, budgets=budgets,
                visions=[dataclasses.asdict(v) for v in visions], **kw)


def _tiny_3b():
    """The stand-in for qwen25vl_3b of tests/test_torch_bench_vlm.py."""
    from vlm_clip_tpu_torch.vlm import qwen_model as PM

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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    ref, data = {}, {}

    cfg = tiny_cfgs()
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    params = {"text": RM.init_text(k1, cfg.text),
              "vision": RM.init_vision(k2, cfg.vision)}
    nf4 = RC.quantize_qwen_params(params, "nf4")
    data["vl_cfg"] = port_qwen_config(cfg)
    data["vl_params"] = to_torch(params)
    cases = []
    ids, vis = _requests(cfg, 4, seed=31)
    ref["tp2"] = _jax_engine(params, cfg, ids, vis, [5, 3, 6, 4])
    cases.append(_case("tp2", "tp2", ids, vis, [5, 3, 6, 4]))
    ids, vis = _requests(cfg, 4, seed=33)
    ref["tp2_nf4"] = _jax_engine(nf4, cfg, ids, vis, [5, 3, 6, 4])
    cases.append(_case("tp2_nf4", "tp2", ids, vis, [5, 3, 6, 4],
                       params=to_torch(nf4)))
    ids, vis = _requests(cfg, 5, seed=33)
    ref["dp2"] = _jax_engine(params, cfg, ids, vis, [5, 3, 6, 4, 2])
    cases.append(_case("dp2", "dp2", ids, vis, [5, 3, 6, 4, 2]))
    for name, mesh, seed in (("tp2_spec", "tp2", 12), ("dp2_spec", "dp2",
                                                       13)):
        ids, vis = _requests(cfg, 2, seed=seed)
        cases.append(_case(name, mesh, ids, vis, [6, 6], sampled=SAMPLED,
                           spec_k=2))
    ids, vis = _requests(cfg, 1)
    refuse = _case("dp2_odd", "dp2", ids, vis, [2], refuse=True)
    refuse["n_slots"] = 3
    cases.append(refuse)
    data["engine"] = cases

    pcfg = tiny_text_cfg()
    pp = RM.init_text(jax.random.PRNGKey(3), pcfg)
    pids = np.random.default_rng(11).integers(
        8, pcfg.vocab_size, size=(2, 2, 6)).astype(np.int64)
    ref["pipe"] = [greedy_oracle(pp, pcfg, pids[m, b], 8, EOS)
                   for m in range(2) for b in range(2)]
    ref["pipe_penalty"] = [greedy_oracle_penalty(pp, pcfg, pids[m, b], 8,
                                                 EOS, 5.0)
                           for m in range(2) for b in range(2)]
    eids = np.random.default_rng(4).integers(
        8, pcfg.vocab_size, size=(2, 1, 5)).astype(np.int64)
    probe = greedy_oracle(pp, pcfg, eids[0, 0], 8, eos=-1)
    # an id whose first occurrence is mid-stream: a real early stop
    eos = next(t for t in probe if 0 < probe.index(t) < 7)
    ref["eos_cut"] = probe.index(eos)
    ref["pipe_eos"] = [greedy_oracle(pp, pcfg, eids[m, 0], 8, eos)
                       for m in range(2)]
    data["pipe"] = {
        "cfg": data_text_cfg(pcfg), "params": to_torch(pp), "ids": pids,
        "eos": EOS, "eos_stop": eos, "ids_eos": eids,
        "ids_sampled": np.random.default_rng(2).integers(
            8, pcfg.vocab_size, size=(2, 2, 5)).astype(np.int64)}

    ccfg = tiny_clip_config()
    cp = init_clip(jax.random.PRNGKey(0), ccfg)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8)
    emb = rng.normal(size=(7, ccfg.projection_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    ref["video"] = np.asarray(RV.score_video_frames(
        cp, ccfg, frames, emb, policy=FP32, stats="clip"))
    from vlm_clip_tpu_torch.core.dtypes import FP32 as PFP32

    data["video"] = {"cfg": port_clip_config(ccfg), "params": to_torch(cp),
                     "frames": frames, "emb": emb, "policy": PFP32}
    data["serve"] = {"cfg": _tiny_3b()}

    inputs = str(tmp / "inputs.pt")
    torch.save(data, inputs)
    return ref, run_ranks("model", 2, inputs, str(tmp))


def data_text_cfg(tc):
    from vlm_clip_tpu_torch.vlm import qwen_model as PM

    return PM.QwenTextConfig(**dataclasses.asdict(tc))


@pytest.mark.parametrize("name", ["tp2", "tp2_nf4", "dp2"])
def test_engine_matches_single_device(run, name):
    """tp 2: weights over model (1 kv head a rank; under NF4 o's 32-row
    shares are not whole 64-row blocks, so o replicates and every rank
    computes both kv heads), slots replicated; dp 2: slots over data (1
    a rank), weights whole; tokens equal the JAX single-device engine's
    across slot reuse and staggered budgets."""
    ref, ranks = run
    rows_heads = {"tp2": (2, 1), "tp2_nf4": (2, 2), "dp2": (1, 2)}[name]
    for r in ranks:
        got = r["engine"][name]
        assert got["tokens"] == ref[name], (got["tokens"], ref[name])
        assert (got["cache_rows"], got["kv_heads"]) == rows_heads


@pytest.mark.parametrize("name", ["tp2_spec", "dp2_spec"])
def test_engine_speculative_sampled_is_valid(run, name):
    _, ranks = run
    assert ranks[0]["engine"][name] == ranks[1]["engine"][name]
    for toks in ranks[0]["engine"][name]["tokens"]:
        assert 0 < len(toks) <= 6
        assert all(0 <= t < VOCAB for t in toks)


def test_engine_dp_rejects_indivisible_slots(run):
    _, ranks = run
    for r in ranks:
        assert "data axis" in r["engine"]["dp2_odd"]


def test_pipeline_greedy_and_penalty_match_oracle(run):
    ref, ranks = run
    for r in ranks:
        assert r["pipe"] == ref["pipe"]
        assert r["pipe_penalty"] == ref["pipe_penalty"]
    assert ref["pipe_penalty"] != ref["pipe"], "penalty changed nothing"
    assert len({t for row in ref["pipe"] for t in row}) > 1


def test_pipeline_eos_trim(run):
    ref, ranks = run
    for r in ranks:
        assert r["pipe_eos"] == ref["pipe_eos"]
    assert len(ref["pipe_eos"][0]) == ref["eos_cut"]
    assert 0 < ref["eos_cut"] < 8


def test_pipeline_sampled_valid_and_seeded(run):
    _, ranks = run
    first, again = ranks[0]["pipe_sampled"]
    assert first == again and len(first) == 4
    assert ranks[1]["pipe_sampled"][0] == first
    for row in first:
        assert len(row) <= 6 and all(0 <= t < 97 for t in row)


def test_pipeline_rejects_bad_shapes(run):
    _, ranks = run
    for r in ranks:
        n_micro, scratch, prompt = r["pipe_refusals"]
        assert "n_micro" in n_micro
        assert "scratch" in scratch
        assert "prompt_ids" in prompt


def test_sharded_video_scores_match_single_device(run):
    ref, ranks = run
    for r in ranks:
        np.testing.assert_allclose(r["video"], ref["video"], atol=2e-5,
                                   rtol=0)


def test_serve_vlm_tp2_answers_with_single_process_tokens(run):
    _, ranks = run
    serve = ranks[0]["serve"]
    assert len(serve["http"]) == 2
    assert serve["http"] == serve["single"]
    assert all(len(t) == 4 for t in serve["http"])
    assert ranks[1]["serve"] is None  # the follower serves no HTTP
