"""Shared helpers for the tests that hold vlm_clip_tpu_torch against
vlm_clip_tpu: the same configs and params on both sides."""

from __future__ import annotations

import dataclasses
import io

import numpy as np

import jax

from vlm_clip_tpu_torch.bridge import tree_to_torch
from vlm_clip_tpu_torch.core import config as PC


def port_clip_config(cfg) -> PC.CLIPConfig:
    """The port's CLIPConfig with the field values of a reference one."""
    return PC.CLIPConfig(
        vision=PC.VisionConfig(**dataclasses.asdict(cfg.vision)),
        text=PC.TextConfig(**dataclasses.asdict(cfg.text)),
        projection_dim=cfg.projection_dim,
        logit_scale_init=cfg.logit_scale_init, name=cfg.name)


def port_adapter_config(acfg) -> PC.AdapterConfig:
    return PC.AdapterConfig(**dataclasses.asdict(acfg))


def to_torch(tree, dtype=None):
    """A reference param tree -> the port's (CPU tensors)."""
    return tree_to_torch(jax.tree.map(np.asarray, tree), "cpu", dtype)


def jpeg_bytes(seed: int = 0, size=(40, 40)) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)
                    ).save(buf, format="JPEG")
    return buf.getvalue()


def port_qwen_config(cfg):
    """The port's QwenVLConfig with the field values of a reference one."""
    from vlm_clip_tpu_torch.vlm import qwen_model as PQ

    return PQ.QwenVLConfig(
        text=PQ.QwenTextConfig(**dataclasses.asdict(cfg.text)),
        vision=PQ.QwenVisionConfig(**dataclasses.asdict(cfg.vision)),
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        eos_token_id=cfg.eos_token_id)


def tiny_qwen(seed: int = 7):
    """(reference cfg, port cfg, reference params, port params): the tiny
    Qwen2.5-VL of tests/test_qwen.py with the JAX package's random init,
    bridged to the port (fp32)."""
    from test_qwen import tiny_cfgs
    from vlm_clip_tpu.vlm import qwen_model as QM

    cfg = tiny_cfgs()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"text": QM.init_text(k1, cfg.text),
              "vision": QM.init_vision(k2, cfg.vision)}
    return cfg, port_qwen_config(cfg), params, to_torch(params)


def port_vision(v):
    """The port's VisionInputs with the field values of a reference one
    (the two dataclasses have the same fields)."""
    from vlm_clip_tpu_torch.vlm import qwen_process as PP

    return PP.VisionInputs(**dataclasses.asdict(v))


def run_ranks(scenario: str, world: int, inputs: str, out_dir: str,
              timeout: float = 300.0):
    """Start ``world`` ranks of tests/_torch_mp_worker.py (gloo on
    localhost, a free port, the launcher's variables) and return each
    rank's results. The caller never brings a process group up."""
    import os
    import socket
    import subprocess
    import sys

    import pytest
    import torch

    worker = os.path.join(os.path.dirname(__file__), "_torch_mp_worker.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, worker, scenario, inputs, out_dir], env=env,
            cwd=os.path.dirname(os.path.dirname(worker)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a {scenario} worker timed out")
        logs.append(out)
    for p, log_text in zip(procs, logs):
        assert p.returncode == 0, log_text[-4000:]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
