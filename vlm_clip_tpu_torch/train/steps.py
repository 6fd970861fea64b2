"""Training steps for pipeline M (port of ``vlm_clip_tpu/train/steps.py``).

One step is forward, ``loss.backward()``, the global gradient norm,
clipping and an Adam/AdamW update of the trainable params in place
(PyTorch's idiom; the reference donates its buffers to the same effect).
Two graphs, as in the reference:

- ``freeze_clip=True`` (adapter-only): the towers run under
  ``torch.no_grad()`` and only the adapter params train; no tower graph
  is kept;
- ``freeze_clip=False`` (full fine-tune): the CLIP params train too.

On the card the adapters' fused kernels carry the backward (K1-K3), and
``fused_loss=True`` routes the contrastive head through K4. After a step,
each trainable param's ``.grad`` holds the gradient the optimizer applied
(clipped when the optimizer clips; under ZeRO-1, this rank's local
gradient).

A step records the spans ``m.step`` and, inside it, ``m.text`` (and in
it ``m.cross_modal``, the shared adapters' forward:
``models/model_m``), ``m.image``, ``m.loss``, ``m.backward`` and
``m.optimizer``, and counts
``m.steps`` and ``m.pairs`` (this process's rows) while tracing is on
(``utils/profiling``).

Data parallelism (the reference's global-batch contract, its
``train/steps.py:1-9``): when a process group of world size > 1 is up,
or ``zero1_mesh`` is given, each rank's batch is its rows of the global
batch (``data/device_prefetch.prefetch_to_device(mesh=...)``), the text
and image features are all-gathered with autograd
(``parallel/distributed.gather_rows``), so every rank computes the
single-device B x B InfoNCE of the whole batch, and the parameter
gradients are averaged over the ranks into that loss's gradient before
the global norm and clipping. ``zero1_mesh`` shards the optimizer state
over the mesh's data axis (``parallel/sharding.Zero1Optimizer``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.core.config import AdapterConfig, CLIPConfig
from vlm_clip_tpu_torch.core.dtypes import BF16, DTypePolicy
from vlm_clip_tpu_torch.models import model_m as M
from vlm_clip_tpu_torch.parallel.distributed import (all_reduce_mean_,
                                                     gather_rows, world_size)
from vlm_clip_tpu_torch.parallel.mesh import axis_group
from vlm_clip_tpu_torch.parallel.sharding import Zero1Optimizer
from vlm_clip_tpu_torch.train.optim import Optimizer, global_norm
from vlm_clip_tpu_torch.utils.profiling import annotate, count

Params = Dict[str, Any]


class TrainState(NamedTuple):
    adapter_params: Params
    clip_params: Params
    opt_state: Any  # a torch optimizer (or a Zero1Optimizer) bound to
    # the trainable leaves
    step: int


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor  # before clipping


def _pixels_on_device(px: torch.Tensor, policy: DTypePolicy,
                      image_size: int) -> torch.Tensor:
    """Preprocessed [B, 3, S, S] float batches pass through; raw
    [B, H, W, 3] uint8 batches are rescaled and CLIP-normalized on the
    device, and resized there first when H, W differ from image_size."""
    if px.dtype == torch.uint8:
        if px.shape[1] != image_size or px.shape[2] != image_size:
            from vlm_clip_tpu_torch.ops.image import resize_normalize

            return resize_normalize(px, image_size,
                                    dtype=policy.compute_dtype)
        from vlm_clip_tpu_torch.data.preprocess import normalize_batch

        return normalize_batch(px, dtype=policy.compute_dtype)
    return px


def _dp_group(zero1_mesh):
    """The data-parallel process group of a step, or None for a
    single-process step."""
    if zero1_mesh is not None:
        if not dist.is_initialized():
            raise ValueError("zero1_mesh needs a process group "
                             "(parallel.distributed.maybe_initialize)")
        return axis_group(zero1_mesh)
    return dist.group.WORLD if world_size() > 1 else None


def make_m_train_step(cfg: CLIPConfig, acfg: AdapterConfig, tx: Optimizer,
                      policy: DTypePolicy = BF16, freeze_clip: bool = True,
                      remat: bool = False, fused_loss: bool = False,
                      zero1_mesh: Optional[Any] = None,
                      impl: str = "auto") -> Callable:
    """(state, batch) -> (state, metrics), with batch = dict(input_ids,
    attention_mask, pixel_values) of tensors on the params' device.
    ``impl`` picks the adapters' implementation (models/adapters.py);
    ``fused_loss`` the K4 contrastive head (its plain version under
    ``impl="torch"``; single-process only, as in the reference: under
    data parallelism the plain head takes the gathered features).
    ``zero1_mesh``: a ``parallel.mesh`` device mesh over whose data axis
    the state's optimizer is sharded (the caller places it with
    ``parallel.sharding.zero1_place``)."""
    group = _dp_group(zero1_mesh)
    if fused_loss and group is not None \
            and dist.get_world_size(group) > 1:
        raise ValueError("fused_loss (the K4 head) is single-device: under "
                         "data parallelism the plain head takes the "
                         "gathered features")

    def loss_fn(adapter_params, clip_params, batch):
        ids = batch["input_ids"]
        mask = batch.get("attention_mask")
        with annotate("m.text"):
            txt = M.m_get_text_features(clip_params, adapter_params, ids,
                                        mask, cfg, acfg, policy, remat,
                                        impl, freeze_clip)
        with annotate("m.image"):
            px = _pixels_on_device(batch["pixel_values"], policy,
                                   cfg.vision.image_size)
            img = M.m_get_image_features(clip_params, adapter_params, px,
                                         cfg, acfg, policy, remat, impl,
                                         freeze_clip)
        with annotate("m.loss"):
            if group is not None:
                txt, img = gather_rows(txt, group), gather_rows(img, group)
            if fused_loss:
                from vlm_clip_tpu_torch.ops import contrastive as K4

                head = K4.contrastive_loss_torch if impl == "torch" \
                    else K4.contrastive_loss_fused
                return head(txt, img, clip_params["logit_scale"])
            return M.contrastive_loss(txt, img,
                                      clip_params["logit_scale"])[0]

    def step(state: TrainState, batch) -> Tuple[TrainState, StepMetrics]:
        with annotate("m.step"):
            opt = state.opt_state
            if zero1_mesh is not None \
                    and not isinstance(opt, Zero1Optimizer):
                raise ValueError("zero1_mesh needs a state placed with "
                                 "parallel.sharding.zero1_place")
            params = trainable_params(opt)
            for p in params:
                p.grad = None
            loss = loss_fn(state.adapter_params, state.clip_params, batch)
            with annotate("m.backward"):
                loss.backward()
            with annotate("m.optimizer"):
                # an unused leaf gets a zero gradient, as in JAX
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if isinstance(opt, Zero1Optimizer):
                    gnorm = opt.step(tx, state.step)
                else:
                    grads = [p.grad for p in params]
                    if group is not None:
                        all_reduce_mean_(grads, group)
                    gnorm = global_norm(grads)
                    tx.update(opt, state.step, grads, gnorm)
            count("m.steps")
            count("m.pairs", batch["input_ids"].shape[0])
            return (state._replace(step=state.step + 1),
                    StepMetrics(loss=loss.detach(), grad_norm=gnorm))

    return step


def trainable_params(opt) -> list:
    """The params a train state's optimizer updates (a torch optimizer's
    or a ``Zero1Optimizer``'s full params)."""
    if isinstance(opt, Zero1Optimizer):
        return opt.params
    return [p for g in opt.param_groups for p in g["params"]]


def make_m_eval_step(cfg: CLIPConfig, acfg: AdapterConfig,
                     policy: DTypePolicy = BF16) -> Callable:
    """(adapter_params, clip_params, batch) -> validation loss; under a
    process group of world size > 1 the batch is this rank's rows and
    the loss the global batch's (the features all-gathered)."""

    @torch.no_grad()
    def eval_step(adapter_params, clip_params, batch):
        px = _pixels_on_device(batch["pixel_values"], policy,
                               cfg.vision.image_size)
        out = M.m_forward(clip_params, adapter_params, batch["input_ids"],
                          batch.get("attention_mask"), px, cfg, acfg,
                          policy, return_loss=False)
        txt, img = out.text_features, out.image_features
        if world_size() > 1:
            txt, img = gather_rows(txt), gather_rows(img)
        return M.contrastive_loss(txt, img, clip_params["logit_scale"])[0]

    return eval_step


def init_train_state(gen: torch.Generator, cfg: CLIPConfig,
                     acfg: AdapterConfig, tx: Optimizer,
                     clip_params: Optional[Params] = None,
                     freeze_clip: bool = True, device="cuda",
                     adapter_params: Optional[Params] = None
                     ) -> TrainState:
    """Fresh (or given) params on ``device`` and an optimizer bound to the
    trainable ones: the adapters, plus the CLIP params when
    ``freeze_clip`` is False."""
    from vlm_clip_tpu_torch.models.clip import init_clip

    if clip_params is None:
        clip_params = init_clip(gen, cfg, device=device)
    if adapter_params is None:
        adapter_params = M.init_m_adapters(gen, cfg, acfg, device=device)
    for p in tree_leaves(clip_params):
        p.requires_grad_(not freeze_clip)
    trainable = tree_leaves(adapter_params)
    if not freeze_clip:
        trainable += tree_leaves(clip_params)
    for p in trainable:
        p.requires_grad_(True)
    return TrainState(adapter_params, clip_params, tx.init(trainable), 0)
