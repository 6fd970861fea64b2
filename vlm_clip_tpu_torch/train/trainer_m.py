"""Pipeline-M trainer (port of ``vlm_clip_tpu/train/trainer_m.py``).

AdamW(lr, weight_decay) over the adapters (or the whole model with
``freeze_clip=False``), linear warmup -> linear decay, global-norm
clipping, a mean train loss per epoch, and best-val, periodic and final
adapter checkpoints in the reference's file format (``best_adapter``,
``adapter_epoch_{n}``, ``final_adapter``). The device is the CLIP
params' device. Host batches reach it through pinned memory with
non-blocking copies; ``device_prefetch=n`` issues the copies of up to n
batches ahead of the step. Full train-state save/restore is not ported
(ROADMAP.md).
"""

from __future__ import annotations

import collections
import logging
import os
import time
from typing import Dict, Iterable, Iterator, List

import numpy as np
import torch

from vlm_clip_tpu_torch.core.config import AdapterConfig, CLIPConfig, \
    TrainConfig
from vlm_clip_tpu_torch.core.dtypes import BF16, DTypePolicy
from vlm_clip_tpu_torch.data.preprocess import normalize_batch
from vlm_clip_tpu_torch.train import checkpoint as ckpt
from vlm_clip_tpu_torch.train.optim import make_optimizer
from vlm_clip_tpu_torch.train.steps import (_check_no_zero1,
                                            init_train_state,
                                            make_m_eval_step,
                                            make_m_train_step)

log = logging.getLogger(__name__)


def _device_batch(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A host Batch -> tensors on ``device`` (pixels normalized there)."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return {"input_ids": put(batch.input_ids),
            "attention_mask": put(batch.attention_mask),
            "pixel_values": normalize_batch(put(batch.images))}


def _prefetch(batches: Iterable, device: torch.device,
              size: int) -> Iterator[Dict[str, torch.Tensor]]:
    """Device batches with the copies of up to ``size`` issued ahead."""
    queue: collections.deque = collections.deque()
    for b in batches:
        queue.append(_device_batch(b, device))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def _copy_into(dst: dict, src: dict) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        else:
            v.copy_(src[k])


class CLIPAdapterTrainer:
    """Reference-API trainer over the pipeline-M train step."""

    def __init__(self, clip_params, cfg: CLIPConfig, acfg: AdapterConfig,
                 train_dataloader, val_dataloader=None,
                 learning_rate: float = 5e-5, weight_decay: float = 0.01,
                 warmup_steps: int = 0, max_grad_norm: float = 1.0,
                 output_dir: str = "./clip_adapter_checkpoints",
                 num_epochs_hint: int = 10, freeze_clip: bool = True,
                 schedule: str = "linear", device_prefetch: int = 0,
                 policy: DTypePolicy = BF16, seed: int = 0,
                 zero1_mesh=None):
        _check_no_zero1(zero1_mesh)
        self.cfg = cfg
        self.acfg = acfg
        self.train_dataloader = train_dataloader
        self.val_dataloader = val_dataloader
        self.output_dir = output_dir
        self.freeze_clip = freeze_clip
        self.device_prefetch = device_prefetch
        self.device = clip_params["logit_scale"].device
        os.makedirs(output_dir, exist_ok=True)

        total_steps = len(train_dataloader) * num_epochs_hint
        tcfg = TrainConfig(learning_rate=learning_rate,
                           weight_decay=weight_decay,
                           warmup_steps=warmup_steps,
                           max_grad_norm=max_grad_norm, schedule=schedule)
        self.tx = make_optimizer(tcfg, total_steps)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_train_state(gen, cfg, acfg, self.tx,
                                      clip_params=clip_params,
                                      freeze_clip=freeze_clip,
                                      device=self.device)
        self._step = make_m_train_step(cfg, acfg, self.tx, policy,
                                       freeze_clip=freeze_clip)
        self._eval_step = make_m_eval_step(cfg, acfg, policy)
        self.history: List[Dict[str, float]] = []

    def _batches(self, loader) -> Iterator[Dict[str, torch.Tensor]]:
        return _prefetch(loader, self.device, self.device_prefetch)

    def train(self, num_epochs: int, save_every: int = 1,
              eval_every: int = 1) -> List[Dict[str, float]]:
        best_val_loss = float("inf")
        for epoch in range(num_epochs):
            t0 = time.time()
            losses = []
            for batch in self._batches(self.train_dataloader):
                self.state, metrics = self._step(self.state, batch)
                losses.append(metrics.loss)
            avg = float(torch.stack(losses).mean())
            rec = {"epoch": epoch + 1, "train_loss": avg,
                   "seconds": time.time() - t0}
            log.info("Epoch %d - Average training loss: %.4f (%.1fs)",
                     epoch + 1, avg, rec["seconds"])

            if self.val_dataloader is not None \
                    and (epoch + 1) % eval_every == 0:
                val_loss = self.evaluate()
                rec["val_loss"] = val_loss
                log.info("Epoch %d - Validation loss: %.4f", epoch + 1,
                         val_loss)
                if val_loss < best_val_loss:
                    best_val_loss = val_loss
                    self.save_model(os.path.join(self.output_dir,
                                                 "best_adapter"))
            if (epoch + 1) % save_every == 0:
                self.save_model(os.path.join(
                    self.output_dir, f"adapter_epoch_{epoch + 1}"))
            self.history.append(rec)
        self.save_model(os.path.join(self.output_dir, "final_adapter"))
        return self.history

    def evaluate(self) -> float:
        if self.val_dataloader is None:
            raise ValueError("Validation dataloader is required for "
                             "evaluation")
        losses = [self._eval_step(self.state.adapter_params,
                                  self.state.clip_params, batch)
                  for batch in self._batches(self.val_dataloader)]
        return float(torch.stack(losses).mean())

    # -- checkpoint API (reference save_model/load_model) ------------------
    def save_model(self, path: str) -> None:
        ckpt.save_adapter_weights(path, self.state.adapter_params)

    def load_model(self, path: str) -> None:
        """Load adapter weights into the trained params in place (the
        optimizer stays bound to them)."""
        params = ckpt.load_adapter_weights(path, self.acfg,
                                           device=self.device)
        with torch.no_grad():
            _copy_into(self.state.adapter_params, params)
