"""The port's tensor parallelism across four real processes (gloo on the
CPU, localhost), held against the JAX package in one process.

The parent makes the params (the reference's init, bridged), computes
the reference's results and starts four ``tests/_torch_mp_worker.py``
ranks (scenario ``tensor``); it never brings a process group up, and
the workers import no jax. The reference's 8-device meshes shrink to
the smallest that still show each case:

- CLIP image features: data 2 x model 2 (the reference's
  test_tp_forward_matches_single_device runs data 2 x model 4), pixels
  sharded over data, atol/rtol 1e-4;
- the Qwen text forward at model 2 and model 4 (its data 2 x model 4),
  fp with an untied head and int8, 8 q heads over 2 kv heads so that
  model 4 takes the GQA fallback; 2e-4 / 1e-3, the reference's;
- the Qwen vision tower at model 2 (its model 4), 2e-4 / 1e-3;
- the engine at data 2 x model 2, greedy tokens equal to the JAX
  single-device engine's (the reference's 2 x 2);
- PipelineGenerator at pipe 2 x model 2 with int8 layers and an int4
  head (the reference's 4 x 2), greedy tokens equal to the JAX oracle.
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
from test_engine import _requests, tiny_cfgs
from test_pipeline_parallel import greedy_oracle, tiny_text_cfg
from vlm_clip_tpu.core.dtypes import FP32
from vlm_clip_tpu.models.clip import get_image_features, init_clip
from vlm_clip_tpu.vlm import qwen_convert as RC
from vlm_clip_tpu.vlm import qwen_model as RM
from vlm_clip_tpu.vlm import qwen_process as RP
from vlm_clip_tpu.vlm.engine import ContinuousBatchingEngine as REngine
from vlm_clip_tpu.vlm.qwen import QwenVLGenerator as RGen

EOS = 7
_MASK = -3.4028235e38


def _port_text_cfg(tc):
    from vlm_clip_tpu_torch.vlm import qwen_model as PM

    return PM.QwenTextConfig(**dataclasses.asdict(tc))


def _port_vision_cfg(vc):
    from vlm_clip_tpu_torch.vlm import qwen_model as PM

    return PM.QwenVisionConfig(**dataclasses.asdict(vc))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ref, data = {}, {}

    cfg = tiny_clip_config()
    params = init_clip(jax.random.PRNGKey(0), cfg)
    px = np.random.default_rng(0).normal(size=(8, 3, 32, 32)).astype(
        np.float32)
    ref["clip"] = np.asarray(get_image_features(params, jnp.asarray(px),
                                                cfg, FP32))
    data["clip"] = {"cfg": port_clip_config(cfg), "params": to_torch(params),
                    "pixels": torch.from_numpy(px)}

    tc = RM.QwenTextConfig(
        hidden_size=64, intermediate_size=128, num_layers=2, num_heads=8,
        num_kv_heads=2, head_dim=16, vocab_size=512,
        mrope_section=(2, 3, 3), tie_word_embeddings=False)
    fp = RM.init_text(jax.random.PRNGKey(0), tc)
    q8 = RC.quantize_qwen_params({"text": fp}, bits=8)["text"]
    ids = np.random.default_rng(0).integers(1, 500, (1, 9))
    pos = jnp.broadcast_to(jnp.arange(9), (3, 1, 9))
    mask = jnp.where(jnp.tril(jnp.ones((9, 9), bool))[None, None], 0.0,
                     _MASK)
    for name, tree in (("fp", fp), ("q8", q8)):
        ref[f"text_{name}"] = np.asarray(RM.text_forward(
            tree, tree["embed_tokens"][jnp.asarray(ids)], pos, tc,
            mask)[0])
    data["text"] = {"cfg": _port_text_cfg(tc), "fp": to_torch(fp),
                    "q8": to_torch(q8), "ids": torch.from_numpy(ids)}

    vcfg = RM.QwenVisionConfig(
        hidden_size=32, intermediate_size=64, out_hidden_size=64, depth=3,
        num_heads=4, patch_size=4, temporal_patch_size=2,
        spatial_merge_size=2, window_size=16, fullatt_block_indexes=(1,))
    vp = RM.init_vision(jax.random.PRNGKey(2), vcfg)
    in_dim = 3 * vcfg.temporal_patch_size * vcfg.patch_size ** 2
    patches = np.random.default_rng(1).normal(size=(64, in_dim)).astype(
        np.float32)
    vin = RP.vision_inputs_from_patches(patches, (1, 8, 8), vcfg)
    args = (vin.patches, vin.rot_pos_emb, vin.window_mask, vin.full_mask)
    ref["vision"] = np.asarray(RM.vision_forward(
        vp, *map(jnp.asarray, args), vcfg))
    data["vision"] = {"cfg": _port_vision_cfg(vcfg), "params": to_torch(vp),
                      "args": tuple(torch.from_numpy(np.asarray(a))
                                    for a in args)}

    ecfg = tiny_cfgs()
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    ep = {"text": RM.init_text(k1, ecfg.text),
          "vision": RM.init_vision(k2, ecfg.vision)}
    ids_e, visions = _requests(ecfg, 6, seed=34)
    budgets = [5, 3, 6, 4, 2, 5]
    reng = REngine(RGen(ep, ecfg, max_len=96, dtype=jnp.float32),
                   n_slots=4, sync_steps=3, refill_chunks=(4, 2, 1))
    rids = [reng.submit(ids_e, v, max_new_tokens=m)
            for v, m in zip(visions, budgets)]
    want = reng.flush()
    ref["engine"] = [want[r] for r in rids]
    data["vl_cfg"] = port_qwen_config(ecfg)
    data["vl_params"] = to_torch(ep)
    data["engine"] = [{
        "name": "dp2tp2", "mesh": "dp2tp2", "n_slots": 4, "sync": 3,
        "refill": (4, 2, 1), "ids": ids_e, "budgets": budgets,
        "visions": [dataclasses.asdict(v) for v in visions]}]

    pcfg = tiny_text_cfg()
    qtext = RC.quantize_qwen_params(
        {"text": RM.init_text(jax.random.PRNGKey(3), pcfg)}, 8,
        head_bits=4)["text"]
    qcfg = dataclasses.replace(pcfg, tie_word_embeddings=False)
    pids = np.random.default_rng(11).integers(
        8, pcfg.vocab_size, size=(2, 1, 6)).astype(np.int64)
    ref["pipe"] = [greedy_oracle(qtext, qcfg, pids[m, 0], 8, EOS)
                   for m in range(2)]
    data["pipe"] = {"cfg": _port_text_cfg(qcfg), "params": to_torch(qtext),
                    "ids": pids, "eos": EOS, "max_new": 8}

    inputs = str(tmp / "inputs.pt")
    torch.save(data, inputs)
    return ref, run_ranks("tensor", 4, inputs, str(tmp))


def test_clip_image_features_data2_model2(run):
    ref, ranks = run
    for r in ranks:
        np.testing.assert_allclose(r["clip"].numpy(), ref["clip"],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["fp", "q8"])
@pytest.mark.parametrize("model", [2, 4])
def test_qwen_text_forward(run, name, model):
    """At model 4 the 2 kv heads replicate: each rank attends with its
    2 q heads over the kv head they read."""
    ref, ranks = run
    for r in ranks:
        np.testing.assert_allclose(r[f"text_{name}_m{model}"].numpy(),
                                   ref[f"text_{name}"], atol=2e-4,
                                   rtol=1e-3)
        assert tuple(r[f"heads_{name}_m{model}"]) == (8 // model, 1)


def test_qwen_vision_tower_model2(run):
    ref, ranks = run
    for r in ranks:
        np.testing.assert_allclose(r["vision"].numpy(), ref["vision"],
                                   atol=2e-4, rtol=1e-3)


def test_engine_dp2_tp2_matches_single_device(run):
    """Weights over model, 4 slots over data (2 a replica, each holding
    its 1 kv head of 2): 6 requests, tokens equal the JAX engine's."""
    ref, ranks = run
    for r in ranks:
        got = r["engine"]["dp2tp2"]
        assert got["tokens"] == ref["engine"]
        assert (got["cache_rows"], got["kv_heads"]) == (2, 1)


def test_pipeline_pp2_tp2_quantized_matches_oracle(run):
    ref, ranks = run
    for r in ranks:
        assert r["pipe_gate"] == "TPLinear"
        assert r["pipe"] == ref["pipe"]
    flat = [t for row in ref["pipe"] for t in row]
    assert len(set(flat)) > 1, "degenerate rollout cannot catch bugs"
