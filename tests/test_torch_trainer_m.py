"""The port's pipeline-M trainer and train CLI against the JAX package's
on a tiny RAF-DB tree (tiny config, FP32, CPU): the loaders yield the
same batches for the same seed, one epoch from the same adapters gives
the same losses, and the checkpoints each writes load in the other.

Tolerances: losses 1e-4 relative (fp32 through the towers, adapters and
three Adam steps, summed in other orders); final adapters 3*lr absolute
(Adam's update is about lr*sign(g) where |g| is near its eps, so a
gradient that differs in its last bits can move a param by up to lr on
each of the three steps).
"""

import os

import numpy as np
import pytest
import torch

import jax

from vlm_clip_tpu.core.config import AdapterConfig as RAdapterConfig
from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.data import rafdb as RD
from vlm_clip_tpu.data.tokenizer import HashTokenizer as RHash
from vlm_clip_tpu.models import clip as RC
from vlm_clip_tpu.train import checkpoint as RCK
from vlm_clip_tpu.train.trainer_m import CLIPAdapterTrainer as RTrainer
from vlm_clip_tpu_torch.bridge import tree_to_numpy
from vlm_clip_tpu_torch.core.config import EMOTIONS
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.data import rafdb as PD
from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer as PHash
from vlm_clip_tpu_torch.train import checkpoint as PCK
from vlm_clip_tpu_torch.train.trainer_m import CLIPAdapterTrainer

from _torch_port import port_adapter_config, port_clip_config, to_torch
from helpers import VOCAB, tiny_clip_config

LR = 1e-3


def _write_tree(root, per_split=(("train", 2), ("val", 1), ("test", 1))):
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in per_split:
        for e in EMOTIONS:
            d = root / split / e
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (40, 48, 3),
                                             dtype=np.uint8)).save(
                    d / f"{e}_{i}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("rafdb"))


def test_loaders_yield_the_reference_batches(tree):
    ref = RD.create_dataloaders(tree, RHash(VOCAB), batch_size=4,
                                image_size=32)
    port = PD.create_dataloaders(tree, PHash(VOCAB), batch_size=4,
                                 image_size=32)
    for split in ("train", "val", "test"):
        assert len(ref[split]) == len(port[split])
        for _ in range(2):  # two epochs: the shuffle advances alike
            for a, b in zip(ref[split], port[split]):
                for f in ("images", "labels", "input_ids",
                          "attention_mask", "valid"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f), err_msg=f)
                assert a.captions == b.captions
    from vlm_clip_tpu_torch.data.pixel_cache import PixelCache

    one = PixelCache(np.zeros((1, 32, 32, 3), np.uint8), ["x.jpg"],
                     np.ones((1,), bool), 32)
    with pytest.raises(ValueError, match="pixel cache .* does not match"):
        port["train"].dataset.attach_pixel_cache(one)


def test_trainer_epoch_matches_reference(tree, tmp_path):
    cfg = tiny_clip_config()
    acfg = RAdapterConfig(text_adapter_size=16, vision_adapter_size=16,
                          shared_adapter_layers=1, shared_num_heads=4)
    params = RC.init_clip(jax.random.PRNGKey(0), cfg)
    kw = dict(learning_rate=LR, weight_decay=0.01, warmup_steps=1,
              max_grad_norm=1.0, num_epochs_hint=1)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_loaders = RD.create_dataloaders(tree, RHash(VOCAB), batch_size=4,
                                        image_size=32)
    ref = RTrainer(params, cfg, acfg, ref_loaders["train"],
                   val_dataloader=ref_loaders["val"],
                   output_dir=str(ref_dir), policy=RFP32, seed=0, **kw)
    init = str(tmp_path / "init.pt")
    ref.save_model(init)

    pacfg = port_adapter_config(acfg)
    loaders = PD.create_dataloaders(tree, PHash(VOCAB), batch_size=4,
                                    image_size=32)
    port = CLIPAdapterTrainer(to_torch(params), port_clip_config(cfg),
                              pacfg, loaders["train"],
                              val_dataloader=loaders["val"],
                              output_dir=str(port_dir), policy=FP32,
                              seed=0, device_prefetch=2, **kw)
    port.load_model(init)  # the reference's initial adapters, in place

    want = ref.train(1)
    got = port.train(1)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-4,
                                   err_msg=key)
    for name in ("best_adapter", "adapter_epoch_1", "final_adapter"):
        assert os.path.isfile(port_dir / name), name
    final = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, ref.state.adapter_params))[0]
    mine = jax.tree_util.tree_flatten_with_path(
        tree_to_numpy(port.state.adapter_params))[0]
    assert [p for p, _ in final] == [p for p, _ in mine]
    for (path, a), (_, b) in zip(final, mine):
        np.testing.assert_allclose(b, a, atol=3 * LR,
                                   err_msg=jax.tree_util.keystr(path))

    # each package reads the other's final checkpoint as written
    from_port = RCK.load_adapter_weights(str(port_dir / "final_adapter"),
                                         acfg)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, from_port)),
                    jax.tree.leaves(tree_to_numpy(
                        port.state.adapter_params))):
        np.testing.assert_array_equal(a, b)
    from_ref = PCK.load_adapter_weights(str(ref_dir / "final_adapter"),
                                        pacfg, device="cpu")
    for a, b in zip(jax.tree.leaves(tree_to_numpy(from_ref)),
                    jax.tree.leaves(jax.tree.map(
                        np.asarray, ref.state.adapter_params))):
        np.testing.assert_array_equal(a, b)
    assert port.evaluate() == pytest.approx(got[0]["val_loss"], rel=1e-6)


def test_train_cli_on_cpu(tree, tmp_path, monkeypatch):
    """The train CLI end to end with --device cpu (the preset swapped for
    the tiny config: the CLI's path is under test here), --zero1 in one
    process, and its refusals."""
    from vlm_clip_tpu_torch.cli import common, train_m
    from vlm_clip_tpu_torch.core.config import AdapterConfig

    monkeypatch.setattr(common, "clip_preset",
                        lambda name: port_clip_config(tiny_clip_config()))
    out = tmp_path / "ckpt"
    res = train_m.main(["--data-root", tree, "--batch-size", "4",
                        "--num-epochs", "1", "--text-adapter-size", "16",
                        "--vision-adapter-size", "16",
                        "--shared-adapter-layers", "1", "--device", "cpu",
                        "--output-dir", str(out), "--warmup-steps", "1"])
    assert np.isfinite(res["history"][0]["train_loss"])
    assert np.isfinite(res["test_loss"])
    acfg = AdapterConfig(text_adapter_size=16, vision_adapter_size=16,
                         shared_adapter_layers=1)
    for name in ("best_adapter", "adapter_epoch_1", "final_adapter"):
        PCK.load_adapter_weights(str(out / name), acfg, device="cpu")
    # without a launcher --zero1 has one rank, which keeps the whole
    # state: the same run, bit for bit
    args = ["--data-root", tree, "--batch-size", "4", "--num-epochs", "1",
            "--text-adapter-size", "16", "--vision-adapter-size", "16",
            "--shared-adapter-layers", "1", "--device", "cpu",
            "--warmup-steps", "1"]
    train_m.main(args + ["--zero1", "--output-dir", str(tmp_path / "z")])
    for name in ("best_adapter", "final_adapter"):
        a = torch.load(str(out / name), weights_only=True)
        b = torch.load(str(tmp_path / "z" / name), weights_only=True)
        for kind in a:
            for k in a[kind]:
                assert torch.equal(a[kind][k], b[kind][k]), (name, kind, k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_m.main(["--data-root", tree])
