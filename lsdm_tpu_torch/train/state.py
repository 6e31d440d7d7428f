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
  update has the full rate); :func:`lr_at` does the same.
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
    step: int = 0


def make_optimizer(model: nn.Module, lr: float = 1e-3,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW matching the reference trainer (``run/train_sdm.py:42-44``)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def create_train_state(model: nn.Module, lr: float = 1e-3,
                       weight_decay: float = 0.01, lr_anneal_steps: int = 0,
                       ema: bool = False) -> TrainState:
    return TrainState(
        model=model, optimizer=make_optimizer(model, lr, weight_decay), lr=lr,
        lr_anneal_steps=lr_anneal_steps,
        ema_params=({k: p.detach().clone() for k, p in model.named_parameters()}
                    if ema else None))


def lr_at(state: TrainState) -> float:
    """The learning rate of the next update: ``optax.linear_schedule(lr, 0,
    lr_anneal_steps)`` at the update count, or the constant rate."""
    if not state.lr_anneal_steps:
        return state.lr
    done = min(state.step, state.lr_anneal_steps) / state.lr_anneal_steps
    return state.lr * (1.0 - done)


@torch.no_grad()
def update_ema(ema_params: Dict[str, torch.Tensor], model: nn.Module,
               rate: float = 0.9999) -> None:
    """EMA update (reference ``diffusion/nn.py:56-64``), in place."""
    for name, p in model.named_parameters():
        ema_params[name].copy_(ema_params[name] * rate + p * (1 - rate))


def apply_gradients(state: TrainState, ema_rate: float = 0.0) -> None:
    """One AdamW update from the gradients in ``.grad`` (zero where None),
    then the EMA; advances ``state.step``."""
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for group in state.optimizer.param_groups:
        group["lr"] = lr_at(state)
    state.optimizer.step()
    state.step += 1
    if ema_rate > 0 and state.ema_params is not None:
        update_ema(state.ema_params, state.model, ema_rate)
