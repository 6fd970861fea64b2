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
(clipped when the optimizer clips). ZeRO-1 (``zero1_mesh``) is not
ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.core.config import AdapterConfig, CLIPConfig
from vlm_clip_tpu_torch.core.dtypes import BF16, DTypePolicy
from vlm_clip_tpu_torch.models import model_m as M
from vlm_clip_tpu_torch.train.optim import Optimizer, global_norm

Params = Dict[str, Any]


class TrainState(NamedTuple):
    adapter_params: Params
    clip_params: Params
    opt_state: torch.optim.Optimizer  # bound to the trainable leaves
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


def _check_no_zero1(zero1_mesh) -> None:
    if zero1_mesh is not None:
        raise NotImplementedError(
            "ZeRO-1 optimizer-state sharding is not ported to "
            "vlm_clip_tpu_torch yet (ROADMAP.md, modules to port, data "
            "parallelism)")


def make_m_train_step(cfg: CLIPConfig, acfg: AdapterConfig, tx: Optimizer,
                      policy: DTypePolicy = BF16, freeze_clip: bool = True,
                      remat: bool = False, fused_loss: bool = False,
                      zero1_mesh: Optional[Any] = None,
                      impl: str = "auto") -> Callable:
    """(state, batch) -> (state, metrics), with batch = dict(input_ids,
    attention_mask, pixel_values) of tensors on the params' device.
    ``impl`` picks the adapters' implementation (models/adapters.py);
    ``fused_loss`` the K4 contrastive head (its plain version under
    ``impl="torch"``)."""
    _check_no_zero1(zero1_mesh)

    def loss_fn(adapter_params, clip_params, batch):
        ids = batch["input_ids"]
        mask = batch.get("attention_mask")
        px = _pixels_on_device(batch["pixel_values"], policy,
                               cfg.vision.image_size)
        if fused_loss:
            from vlm_clip_tpu_torch.ops import contrastive as K4

            head = K4.contrastive_loss_torch if impl == "torch" \
                else K4.contrastive_loss_fused
            txt = M.m_get_text_features(clip_params, adapter_params, ids,
                                        mask, cfg, acfg, policy, remat,
                                        impl, freeze_clip)
            img = M.m_get_image_features(clip_params, adapter_params, px,
                                         cfg, acfg, policy, remat, impl,
                                         freeze_clip)
            return head(txt, img, clip_params["logit_scale"])
        return M.m_forward(clip_params, adapter_params, ids, mask, px, cfg,
                           acfg, policy, return_loss=True, remat=remat,
                           impl=impl, freeze_clip=freeze_clip).loss

    def step(state: TrainState, batch) -> Tuple[TrainState, StepMetrics]:
        params = [p for g in state.opt_state.param_groups
                  for p in g["params"]]
        for p in params:
            p.grad = None
        loss = loss_fn(state.adapter_params, state.clip_params, batch)
        loss.backward()
        for p in params:
            if p.grad is None:  # unused leaf: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        gnorm = global_norm(grads)
        tx.update(state.opt_state, state.step, grads, gnorm)
        return (state._replace(step=state.step + 1),
                StepMetrics(loss=loss.detach(), grad_norm=gnorm))

    return step


def make_m_eval_step(cfg: CLIPConfig, acfg: AdapterConfig,
                     policy: DTypePolicy = BF16) -> Callable:
    """(adapter_params, clip_params, batch) -> validation loss."""

    @torch.no_grad()
    def eval_step(adapter_params, clip_params, batch):
        return M.m_forward(
            clip_params, adapter_params, batch["input_ids"],
            batch.get("attention_mask"),
            _pixels_on_device(batch["pixel_values"], policy,
                              cfg.vision.image_size),
            cfg, acfg, policy, return_loss=True).loss

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
