"""Optimizer recipes (port of ``vlm_clip_tpu/train/optim.py``).

The same functions optax computes there, on ``torch.optim``:

- :func:`make_schedule`: constant, linear warmup -> linear decay to 0
  (optax ``join_schedules`` of two ``linear_schedule``s), or warmup ->
  cosine decay (``warmup_cosine_decay_schedule``); the step count starts
  at 0, so the first update of a warmed-up run has learning rate 0;
- :func:`make_optimizer`: global-norm clipping then AdamW (decoupled
  decay ``lr*wd*p``, which ``torch.optim.AdamW`` applies as optax's
  ``adamw`` does) or Adam when ``weight_decay`` is 0. Clipping follows
  ``optax.clip_by_global_norm``: gradients are scaled by
  ``max_norm / norm`` only when ``norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and is
  not the same function).

The reference's ``trainable_mask`` is left out: no caller passes it
(ROADMAP.md, section 3, records how optax.masked treats masked leaves).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional

import torch

from vlm_clip_tpu_torch.core.config import TrainConfig


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule(init, end, steps) (constant init when
    steps <= 0)."""
    if steps <= 0:
        return lambda count: init

    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax.join_schedules: schedule i+1 takes over, counted from 0, at
    boundary i."""
    def f(count: int) -> float:
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out
    return f


def make_schedule(cfg: TrainConfig,
                  total_steps: int) -> Callable[[int], float]:
    """Learning rate as a function of the number of updates already
    applied (0 for the first update)."""
    lr = cfg.learning_rate
    if cfg.schedule == "constant":
        return lambda count: lr
    if cfg.schedule == "linear":
        return _join([_linear(0.0, lr, max(cfg.warmup_steps, 1)),
                      _linear(lr, 0.0,
                              max(total_steps - cfg.warmup_steps, 1))],
                     [cfg.warmup_steps])
    if cfg.schedule == "cosine":
        decay_steps = max(total_steps, cfg.warmup_steps + 1) \
            - cfg.warmup_steps

        def cosine(count: int) -> float:
            c = min(count, decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return _join([_linear(0.0, lr, cfg.warmup_steps), cosine],
                     [cfg.warmup_steps])
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (fp32, on device)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: g -> g / norm * max_norm where
    norm >= max_norm, unchanged otherwise (no host sync)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


@dataclasses.dataclass
class Optimizer:
    """What :func:`make_optimizer` builds: the schedule, the clipping
    bound and the Adam/AdamW settings. :meth:`init` binds it to params."""

    schedule: Callable[[int], float]
    weight_decay: float
    max_grad_norm: Optional[float]

    def init(self, params: List[torch.Tensor]) -> torch.optim.Optimizer:
        """A torch optimizer over ``params`` (each must require grad); the
        train step sets its learning rate from the schedule before each
        update."""
        lr = self.schedule(0)
        if self.weight_decay > 0.0:
            return torch.optim.AdamW(params, lr=lr,
                                     weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=lr)

    def update(self, opt: torch.optim.Optimizer, count: int,
               grads: List[torch.Tensor], norm: torch.Tensor) -> None:
        """Clip ``grads`` (the ``.grad`` of opt's params, in place), set
        the learning rate for update number ``count`` and step."""
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, norm, self.max_grad_norm)
        for group in opt.param_groups:
            group["lr"] = self.schedule(count)
        opt.step()


def make_optimizer(cfg: TrainConfig, total_steps: int = 0) -> Optimizer:
    """Clip-then-AdamW (or Adam) on the configured schedule."""
    return Optimizer(schedule=make_schedule(cfg, total_steps),
                     weight_decay=cfg.weight_decay,
                     max_grad_norm=cfg.max_grad_norm)


def adam(learning_rate: float) -> Optimizer:
    """Plain Adam at a constant rate (``optax.adam(lr)``, the bench
    step's optimizer)."""
    return make_optimizer(TrainConfig(learning_rate=learning_rate))
