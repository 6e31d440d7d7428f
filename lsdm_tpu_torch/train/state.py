"""Train state: the model, its AdamW optimizer, the step count and the EMA.

Counterpart of ``lsdm_tpu/train/state.py``.  The JAX package's optimizer
is ``optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)``
over every parameter (optax has no mask), with an optional linear anneal
of the learning rate to 0 over ``lr_anneal_steps`` updates.  Here it is
``torch.optim.AdamW`` with the same settings.  Two differences of the
libraries are closed by hand:

* optax decays every parameter, also one whose gradient is zero; torch
  skips a parameter whose ``.grad`` is None (``attn_layer``'s value
  projection and ``out_proj`` never reach the loss: the model reads only
  its attention weights), so :func:`apply_gradients` gives those a zero
  gradient first;
* optax's schedule reads its update count before the update (the first
  update has the full rate); :func:`lr_at` does the same, from the count of
  updates applied (``TrainState.updates``), which the step count exceeds
  where updates were skipped.

``skip_nonfinite`` is ``optax.apply_if_finite(adamw, 100)``
(:class:`AdamWIfFinite`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.AdamW
    lr: float
    lr_anneal_steps: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0  # train steps taken
    updates: int = 0  # optimizer updates applied (the schedule's count)


class AdamWIfFinite(torch.optim.AdamW):
    """AdamW wrapped as ``optax.apply_if_finite(adamw, max_consecutive_errors)``
    (``lsdm_tpu/train/state.py:50-74``): a step whose gradients hold a NaN
    or an infinity updates nothing, not the moments, the weight decay or
    AdamW's step count; it counts toward ``max_consecutive_errors``
    consecutive such steps, after which the update is applied anyway (the
    101st at the default, as optax's ``notfinite_count >
    max_consecutive_errors``).  A finite step resets the count.  The check
    reads one flag back to the host a step (a device sync).
    ``last_applied`` says whether the last :meth:`step` updated."""

    def __init__(self, params, max_consecutive_errors: int = 100, **kw):
        super().__init__(params, **kw)
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.last_applied = True

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        self.last_applied = (finite or self.notfinite_count
                             > self.max_consecutive_errors)
        return super().step(closure) if self.last_applied else None

    def state_dict(self):
        sd = super().state_dict()
        sd["apply_if_finite"] = {"notfinite_count": self.notfinite_count,
                                 "total_notfinite": self.total_notfinite}
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        counts = state_dict.pop("apply_if_finite", {})
        super().load_state_dict(state_dict)
        self.notfinite_count = counts.get("notfinite_count", 0)
        self.total_notfinite = counts.get("total_notfinite", 0)


def make_optimizer(model: nn.Module, lr: float = 1e-3,
                   weight_decay: float = 0.01, skip_nonfinite: bool = False
                   ) -> torch.optim.AdamW:
    """AdamW matching the reference trainer (``run/train_sdm.py:42-44``);
    ``skip_nonfinite``: :class:`AdamWIfFinite`, which skips a step with a
    non-finite gradient, as the JAX function's ``optax.apply_if_finite``
    (a library option: no CLI sets it, in JAX as here)."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    if skip_nonfinite:
        return AdamWIfFinite(model.parameters(), **kw)
    return torch.optim.AdamW(model.parameters(), **kw)


def create_train_state(model: nn.Module, lr: float = 1e-3,
                       weight_decay: float = 0.01, lr_anneal_steps: int = 0,
                       ema: bool = False, skip_nonfinite: bool = False
                       ) -> TrainState:
    return TrainState(
        model=model,
        optimizer=make_optimizer(model, lr, weight_decay, skip_nonfinite),
        lr=lr, lr_anneal_steps=lr_anneal_steps,
        ema_params=({k: p.detach().clone() for k, p in model.named_parameters()}
                    if ema else None))


def lr_at(state: TrainState) -> float:
    """The learning rate of the next update: ``optax.linear_schedule(lr, 0,
    lr_anneal_steps)`` at the count of updates applied, or the constant
    rate."""
    if not state.lr_anneal_steps:
        return state.lr
    done = min(state.updates, state.lr_anneal_steps) / state.lr_anneal_steps
    return state.lr * (1.0 - done)


@torch.no_grad()
def update_ema(ema_params: Dict[str, torch.Tensor], model: nn.Module,
               rate: float = 0.9999) -> None:
    """EMA update (reference ``diffusion/nn.py:56-64``), in place."""
    for name, p in model.named_parameters():
        ema_params[name].copy_(ema_params[name] * rate + p * (1 - rate))


def apply_gradients(state: TrainState, ema_rate: float = 0.0) -> None:
    """One AdamW update from the gradients in ``.grad`` (zero where None),
    then the EMA; advances ``state.step``, and ``state.updates`` where the
    update was applied (an :class:`AdamWIfFinite` may skip it; the step,
    the BatchNorm statistics and the EMA advance all the same, as in the
    JAX trainer)."""
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for group in state.optimizer.param_groups:
        group["lr"] = lr_at(state)
    state.optimizer.step()
    state.step += 1
    state.updates += int(getattr(state.optimizer, "last_applied", True))
    if ema_rate > 0 and state.ema_params is not None:
        update_ema(state.ema_params, state.model, ema_rate)
