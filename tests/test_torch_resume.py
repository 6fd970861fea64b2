"""Full train-state resume in the port (train/checkpoint.py
save_train_state / AsyncTrainStateSaver / restore_train_state, and
CLIPAdapterTrainer.save_full_state / finish_saves /
restore_full_state), on the tiny config on the CPU.

- A trainer restored from a save continues bit for bit as if it had not
  stopped: the losses, the params and the optimizer's moments of
  N + save + restore + M steps equal N + M uninterrupted steps exactly,
  for a synchronous save, a background save with a step taken while it
  is in flight, and a full fine-tune (the CLIP params saved too).
- Against the JAX package: its trainer's same sequence (N steps, orbax
  save, restore into a fresh trainer, M steps) gives the port's losses
  within 1e-5 relative, the step tolerance of
  tests/test_torch_train_step.py (fp32 through the towers and adapters,
  summed in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.core.config import AdapterConfig as RAdapterConfig
from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.data.preprocess import normalize_batch_tpu
from vlm_clip_tpu.models import clip as RC
from vlm_clip_tpu.train.trainer_m import CLIPAdapterTrainer as RTrainer
from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.data.preprocess import normalize_batch
from vlm_clip_tpu_torch.train import checkpoint as CK
from vlm_clip_tpu_torch.train.trainer_m import CLIPAdapterTrainer

from _torch_port import port_adapter_config, port_clip_config, to_torch
from helpers import tiny_clip_config

N, M = 2, 2  # steps before the save, steps after the restore
KW = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=2,
          max_grad_norm=1.0, num_epochs_hint=1)
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_clip_config()
    acfg = RAdapterConfig(text_adapter_size=16, vision_adapter_size=16,
                          shared_adapter_layers=1, shared_num_heads=4)
    params = RC.init_clip(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    host = [{"u8": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             "ids": rng.integers(1, 90, (4, 12)).astype(np.int32),
             "mask": np.ones((4, 12), np.int32)} for _ in range(N + M)]
    return cfg, acfg, params, host


def _port_batches(host):
    return [{"input_ids": torch.from_numpy(b["ids"]),
             "attention_mask": torch.from_numpy(b["mask"]),
             "pixel_values": normalize_batch(torch.from_numpy(b["u8"]))}
            for b in host]


def _trainer(setup, tmp_path, seed, freeze_clip=True):
    cfg, acfg, params, host = setup
    return CLIPAdapterTrainer(
        to_torch(params), port_clip_config(cfg), port_adapter_config(acfg),
        host, output_dir=str(tmp_path / f"out{seed}"), policy=FP32,
        seed=seed, freeze_clip=freeze_clip, **KW)


def _run(trainer, batches):
    losses = []
    for b in batches:
        trainer.state, m = trainer._step(trainer.state, b)
        losses.append(float(m.loss))
    return losses


def _opt_tensors(state):
    return [t for s in state.opt_state.state.values() for t in s.values()]


def _params(state, freeze_clip):
    return tree_leaves(state.adapter_params) + (
        [] if freeze_clip else tree_leaves(state.clip_params))


@pytest.mark.parametrize("mode", ["sync", "async", "async_full_finetune"])
def test_resumed_equals_uninterrupted(setup, tmp_path, mode):
    freeze = mode != "async_full_finetune"
    batches = _port_batches(setup[3])
    whole = _trainer(setup, tmp_path, 0, freeze)
    want = _run(whole, batches)

    first = _trainer(setup, tmp_path, 0, freeze)
    got = _run(first, batches[:N])
    path = str(tmp_path / "state.pt")
    first.save_full_state(path, wait=mode == "sync")
    # a step while the background save is in flight: the snapshot is
    # already taken, so it neither changes the file nor this step
    assert _run(first, batches[N:N + 1]) == want[N:N + 1]
    first.finish_saves()

    resumed = _trainer(setup, tmp_path, 1, freeze)  # other random adapters
    assert not all(torch.equal(a, b) for a, b in zip(
        _params(resumed.state, freeze), _params(first.state, freeze)))
    resumed.restore_full_state(path)
    assert resumed.state.step == N
    got += _run(resumed, batches[N:])
    assert got == want  # bit for bit
    assert resumed.state.step == whole.state.step == N + M
    for a, b in zip(_params(resumed.state, freeze),
                    _params(whole.state, freeze)):
        assert torch.equal(a, b)
    for a, b in zip(_opt_tensors(resumed.state), _opt_tensors(whole.state)):
        assert torch.equal(a, b)


def test_restore_refuses_another_state(setup, tmp_path):
    trainer = _trainer(setup, tmp_path, 0)
    path = str(tmp_path / "state.pt")
    CK.save_train_state(path, trainer.state)
    full = _trainer(setup, tmp_path, 1, freeze_clip=False)
    with pytest.raises(ValueError, match="CLIP params train"):
        full.restore_full_state(path)
    torch.save({"format": "something else"}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="train_state"):
        trainer.restore_full_state(str(tmp_path / "other.pt"))
    saver = CK.AsyncTrainStateSaver()
    saver.save(str(tmp_path / "nodir" / "x" / "state.pt"), trainer.state)
    saver.close()
    assert (tmp_path / "nodir" / "x" / "state.pt").is_file()


def test_resume_sequence_matches_reference(setup, tmp_path):
    """N steps, a full save, a fresh trainer restored from it, M steps:
    the port's losses against the JAX trainer's (orbax) sequence."""
    cfg, acfg, params, host = setup
    ref = RTrainer(params, cfg, acfg, host, output_dir=str(tmp_path / "r0"),
                   policy=RFP32, seed=0, **KW)
    init = str(tmp_path / "init.pt")
    ref.save_model(init)
    rbatches = [{"input_ids": jnp.asarray(b["ids"]),
                 "attention_mask": jnp.asarray(b["mask"]),
                 "pixel_values": normalize_batch_tpu(jnp.asarray(b["u8"]))}
                for b in host]

    def rrun(trainer, batches):
        out = []
        for b in batches:
            trainer.state, m = trainer._step(trainer.state, b)
            out.append(float(m.loss))
        return out

    want = rrun(ref, rbatches[:N])
    ref.save_full_state(str(tmp_path / "ref_state"))
    ref2 = RTrainer(params, cfg, acfg, host, output_dir=str(tmp_path / "r1"),
                    policy=RFP32, seed=1, **KW)
    ref2.restore_full_state(str(tmp_path / "ref_state"))
    want += rrun(ref2, rbatches[N:])

    port = _trainer(setup, tmp_path, 0)
    port.load_model(init)  # the reference's initial adapters
    batches = _port_batches(host)
    got = _run(port, batches[:N])
    port.save_full_state(str(tmp_path / "port_state.pt"), wait=False)
    port.finish_saves()
    port2 = _trainer(setup, tmp_path, 1)
    port2.restore_full_state(str(tmp_path / "port_state.pt"))
    got += _run(port2, batches[N:])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
