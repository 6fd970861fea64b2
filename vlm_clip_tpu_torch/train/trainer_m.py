"""Pipeline-M trainer (port of ``vlm_clip_tpu/train/trainer_m.py``).

AdamW(lr, weight_decay) over the adapters (or the whole model with
``freeze_clip=False``), linear warmup -> linear decay, global-norm
clipping, a mean train loss per epoch, and best-val, periodic and final
adapter checkpoints in the reference's file format (``best_adapter``,
``adapter_epoch_{n}``, ``final_adapter``). The device is the CLIP
params' device. Host batches reach it through
``data/device_prefetch.prefetch_to_device`` (pinned memory, non-blocking
copies on a side stream); ``device_prefetch=n`` issues the copies of
n - 1 batches ahead of the step, as the reference's does. Full
train-state save/restore: :meth:`CLIPAdapterTrainer.save_full_state`
(``wait=False`` writes in the background, at most one save in flight),
:meth:`~CLIPAdapterTrainer.finish_saves` and
:meth:`~CLIPAdapterTrainer.restore_full_state`, after which training
continues bit for bit as if it had not stopped (train/checkpoint.py).

Data parallelism: under a process group of world size > 1 (or with
``zero1_mesh``, which also shards Adam's moments over the mesh's data
axis), each rank copies its rows of every batch and the step computes
the global-batch loss (train/steps.py); the batch size must divide among
the ranks. Adapter files are written by rank 0 only; a full save gathers
the moment shards on rank 0, which writes the file, and every rank waits
for it before going on.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterator, List

import torch

from vlm_clip_tpu_torch.core.config import AdapterConfig, CLIPConfig, \
    TrainConfig
from vlm_clip_tpu_torch.core.dtypes import BF16, DTypePolicy
from vlm_clip_tpu_torch.data.device_prefetch import prefetch_to_device
from vlm_clip_tpu_torch.data.preprocess import normalize_batch
from vlm_clip_tpu_torch.train import checkpoint as ckpt
from vlm_clip_tpu_torch.train.optim import make_optimizer
from vlm_clip_tpu_torch.parallel.distributed import (global_mesh,
                                                     is_primary, world_size)
from vlm_clip_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from vlm_clip_tpu_torch.parallel.sharding import Zero1Optimizer, zero1_place
from vlm_clip_tpu_torch.train.steps import (init_train_state,
                                            make_m_eval_step,
                                            make_m_train_step)

log = logging.getLogger(__name__)


def _host_batch(batch) -> Dict:
    """The arrays of a host Batch that the step reads."""
    return {"input_ids": batch.input_ids,
            "attention_mask": batch.attention_mask,
            "pixel_values": batch.images}


def device_batches(loader, device: torch.device, size: int = 0,
                   mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """A loader's batches as tensors on ``device``, the uint8 pixels
    normalized there (fp32), the copies issued ``size`` batches ahead
    (``prefetch_to_device``); with ``mesh``, this rank's rows."""
    for b in prefetch_to_device(loader, size=size, transform=_host_batch,
                                device=device, mesh=mesh):
        b["pixel_values"] = normalize_batch(b["pixel_values"])
        yield b


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
        self.cfg = cfg
        self.acfg = acfg
        self.train_dataloader = train_dataloader
        self.val_dataloader = val_dataloader
        self.output_dir = output_dir
        self.freeze_clip = freeze_clip
        self.device_prefetch = device_prefetch
        self._async_saver = None  # lazy AsyncTrainStateSaver
        self.device = clip_params["logit_scale"].device
        # the mesh whose data axis splits each batch (None: one process)
        self.mesh = zero1_mesh if zero1_mesh is not None else (
            global_mesh(device=self.device.type) if world_size() > 1
            else None)
        ranks = 1 if self.mesh is None else axis_size(self.mesh, DATA_AXIS)
        for loader in (train_dataloader, val_dataloader):
            n = getattr(loader, "batch_size", None)
            if n is not None and n % ranks:
                raise ValueError(f"batch size {n} does not divide among "
                                 f"{ranks} ranks")
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
        if zero1_mesh is not None:
            self.state = self.state._replace(opt_state=zero1_place(
                self.state.opt_state, zero1_mesh, self.tx))
        self._step = make_m_train_step(cfg, acfg, self.tx, policy,
                                       freeze_clip=freeze_clip,
                                       zero1_mesh=zero1_mesh)
        self._eval_step = make_m_eval_step(cfg, acfg, policy)
        self.history: List[Dict[str, float]] = []

    def _batches(self, loader) -> Iterator[Dict[str, torch.Tensor]]:
        return device_batches(loader, self.device, self.device_prefetch,
                              self.mesh)

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

    # -- checkpoints (reference save_model/load_model + full resume) ------
    def save_model(self, path: str) -> None:
        """The reference-format adapter file, written by rank 0 (the
        params are the same on every rank)."""
        if is_primary():
            ckpt.save_adapter_weights(path, self.state.adapter_params)

    def load_model(self, path: str) -> None:
        """Load adapter weights into the trained params in place (the
        optimizer stays bound to them; under ZeRO-1 its shards follow)."""
        params = ckpt.load_adapter_weights(path, self.acfg,
                                           device=self.device)
        with torch.no_grad():
            ckpt.copy_into(self.state.adapter_params, params)
        if isinstance(self.state.opt_state, Zero1Optimizer):
            self.state.opt_state.sync_shards()

    def save_full_state(self, path: str, wait: bool = True) -> None:
        """Full train-state save (train/checkpoint.py). ``wait=False``
        takes a device snapshot and returns: the copy to pinned host
        memory and the file write run in the background while training
        continues; a later save or :meth:`finish_saves` joins it."""
        if wait:
            ckpt.save_train_state(path, self.state)
            return
        if self._async_saver is None:
            self._async_saver = ckpt.AsyncTrainStateSaver()
        self._async_saver.save(path, self.state)

    def finish_saves(self) -> None:
        """Block until any in-flight background save has fully written
        (and raise its error, if it failed)."""
        if self._async_saver is not None:
            self._async_saver.wait()

    def restore_full_state(self, path: str) -> None:
        """Restore params, optimizer moments and step count in place."""
        self.finish_saves()
        self.state = ckpt.restore_train_state(path, self.state)
