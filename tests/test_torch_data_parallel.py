"""The port's data parallelism across two real processes (gloo on the
CPU, localhost), held against the JAX package's single-process M step on
the whole batch.

The parent makes the params (the reference's init) and the global batch,
runs the reference's step on the whole batch, and starts two
``tests/_torch_dp_worker.py`` ranks under the launcher's variables; it
never brings a process group up itself. The workers import no jax.

Tolerances: loss and adapter params 1e-5, the global grad norm 1e-5
relative (fp32; the ranks gather the features and average the gradients
in another order than XLA sums the whole batch); Adam at eps 1e-2 for
the ZeRO-1 cases, because plain Adam's first update is about
sign(g) * lr, so reduction-order noise on a near-zero gradient would
flip a whole update (the reference's tests/test_sharding.py says the
same).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.core.config import AdapterConfig
from vlm_clip_tpu.core.dtypes import FP32
from vlm_clip_tpu.train.steps import init_train_state, make_m_train_step
from vlm_clip_tpu_torch.bridge import tree_to_numpy

from _torch_port import port_adapter_config, port_clip_config, to_torch
from helpers import VOCAB, tiny_clip_config

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_dp_worker.py")
B = 8
TOL = 1e-5
CLIP_NORM = 2.0  # below every step's global grad norm: clipping engages


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(reference results, [rank 0's, rank 1's observations])."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = tiny_clip_config()
    acfg = AdapterConfig(text_adapter_size=16, vision_adapter_size=16,
                         shared_adapter_layers=2, shared_num_heads=4)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, VOCAB, (B, 10)).astype(np.int32)
    mask = np.ones((B, 10), np.int32)
    ids[-1, 5:], mask[-1, 5:] = 0, 0  # a padded row
    batch = {"input_ids": ids, "attention_mask": mask,
             "pixel_values": rng.normal(size=(B, 3, 32, 32)).astype(
                 np.float32)}

    clip = optax.clip_by_global_norm(CLIP_NORM)
    ref = {}
    for name, tx, frozen in (
            ("sgd", optax.sgd(0.1), True),
            ("sgd_full", optax.sgd(0.1), False),
            ("sgd_clip", optax.chain(clip, optax.sgd(0.1)), True),
            ("zero1", optax.adam(1e-3, eps=1e-2), True),
            ("zero1_clip",
             optax.chain(clip, optax.adam(1e-3, eps=1e-2)), True)):
        state = init_train_state(jax.random.PRNGKey(2), cfg, acfg, tx,
                                 freeze_clip=frozen)
        if name == "sgd":  # the step donates its buffers: copy first
            clip0, adapters0 = (to_torch(state.clip_params),
                                to_torch(state.adapter_params))
        step = make_m_train_step(cfg, acfg, tx, FP32, freeze_clip=frozen)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        state, m1 = step(state, jb)
        state, m2 = step(state, jb)
        ref[name] = {"loss": [float(m1.loss), float(m2.loss)],
                     "grad_norm": [float(m1.grad_norm),
                                   float(m2.grad_norm)],
                     "params": _flat(state.adapter_params if frozen else
                                     [state.adapter_params,
                                      state.clip_params])}

    inputs = str(tmp / "inputs.pt")
    torch.save({
        "cfg": dataclasses.asdict(port_clip_config(cfg)),
        "acfg": dataclasses.asdict(port_adapter_config(acfg)),
        "clip": clip0, "adapters": adapters0, "clip_norm": CLIP_NORM,
        "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
        "images_u8": torch.from_numpy(rng.integers(
            0, 255, (B, 32, 32, 3), dtype=np.uint8)),
    }, inputs)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, inputs, str(tmp)], env=env,
            cwd=os.path.dirname(os.path.dirname(_WORKER)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a data-parallel worker timed out")
        logs.append(out)
    for p, log_text in zip(procs, logs):
        assert p.returncode == 0, log_text[-4000:]
    return ref, [torch.load(str(tmp / f"rank{r}.pt"), weights_only=True)
                 for r in range(2)]


@pytest.mark.parametrize("name", ["sgd", "sgd_full", "sgd_clip", "zero1",
                                  "zero1_clip"])
def test_two_rank_step_equals_single_process_reference(run, name):
    """Both ranks see the same global-batch loss and global grad norm,
    and they and the trained params after two steps equal the
    reference's whole-batch step (sgd_full: the CLIP params train too,
    logit_scale among them, which the loss reads directly and not
    through a rank's rows; *_clip: clipped to the global norm, which a
    rank's local gradient would get wrong)."""
    ref, ranks = run
    a, b = (r[name] for r in ranks)
    assert a["loss"] == b["loss"]
    assert a["grad_norm"] == b["grad_norm"]
    np.testing.assert_allclose(a["loss"], ref[name]["loss"], atol=TOL)
    np.testing.assert_allclose(a["grad_norm"], ref[name]["grad_norm"],
                               rtol=TOL)
    if name.endswith("_clip"):
        assert min(ref[name]["grad_norm"]) > CLIP_NORM
    for r in (a, b):
        got = _flat(tree_to_numpy(r["params"]))
        assert len(got) == len(ref[name]["params"])
        for x, y in zip(got, ref[name]["params"]):
            np.testing.assert_allclose(x, y, atol=TOL, rtol=0)


def test_zero1_moments_hold_half_of_every_shardable_leaf(run):
    _, ranks = run
    for r in ranks:
        moments = r["zero1"]["moments"]
        assert any(sharded for *_, sharded in moments)
        for numel, mu, nu, sharded in moments:
            assert mu == nu == (numel // 2 if sharded else numel)


def test_zero1_resume_continues_bit_for_bit(run):
    """Rank 0 saved the full state after step 1 (moment shards gathered);
    both ranks restored it and step 2 repeated the in-memory step 2."""
    _, ranks = run
    for r in ranks:
        assert r["zero1"]["restored_step"] == 1
        assert r["zero1"]["resume_bits"]


def test_k4_head_refused_and_batch_must_divide(run):
    _, ranks = run
    for r in ranks:
        assert r["fused_refused"] and r["odd_refused"]


def test_only_rank_0_writes_adapter_files(run):
    _, ranks = run
    assert ranks[0]["trainer"]["files"] == ["adapter_epoch_1",
                                            "best_adapter", "final_adapter"]
    assert ranks[1]["trainer"]["files"] == []
    assert ranks[0]["trainer"]["loss"] == ranks[1]["trainer"]["loss"]
    assert ranks[0]["trainer"]["val"] == ranks[1]["trainer"]["val"]
    assert np.isfinite(ranks[0]["trainer"]["loss"])


def test_zero1_load_model_reaches_the_shards(run):
    """The trainer's load_model copies the loaded adapters into the
    params and into each rank's ZeRO-1 shards, which the next step
    updates."""
    _, ranks = run
    for r in ranks:
        assert r["trainer"]["load_synced"]
