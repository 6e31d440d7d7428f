"""DDPM ancestral and DDIM sampling loops.

Counterpart of ``p_sample_loop`` / ``ddim_sample_loop`` in
``lsdm_tpu/diffusion/sampler.py`` (reference ``gaussian_diffusion.py:
611-759, 908-1022``) as plain Python loops over T steps.  Both take an
optional initial image ``x_init`` (B, ...) and an optional per-step noise
table ``noise`` (T, B, ...), so a caller can feed draws made elsewhere
(the parity tests feed the JAX package's); what is not given is drawn
from ``generator``.  Both return (final sample, last model output).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lsdm_tpu_torch.diffusion.gaussian import (
    DenoiseFn, DenoiserOutput, p_mean_variance, predict_eps_from_xstart)
from lsdm_tpu_torch.diffusion.schedule import Schedule, extract


def _draws(schedule: Schedule, shape: Tuple[int, ...],
           x_init: Optional[torch.Tensor], noise: Optional[torch.Tensor],
           generator: Optional[torch.Generator], device) -> Tuple[torch.Tensor, torch.Tensor]:
    T = schedule.num_timesteps
    if x_init is None:
        x_init = torch.randn(shape, generator=generator, device=device)
    if noise is None:
        noise = torch.randn((T,) + tuple(shape), generator=generator,
                            device=device)
    if tuple(x_init.shape) != tuple(shape) or tuple(noise.shape) != (T,) + tuple(shape):
        raise ValueError(f"x_init must be {tuple(shape)} and noise "
                         f"{(T,) + tuple(shape)}")
    return x_init, noise


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    m = (t != 0).float()
    return m.reshape(m.shape + (1,) * (ndim - 1))


def p_sample_loop(schedule: Schedule, model_fn: DenoiseFn,
                  shape: Tuple[int, ...],
                  generator: Optional[torch.Generator] = None,
                  x_init: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  clip_denoised: bool = True,
                  device=None) -> Tuple[torch.Tensor, DenoiserOutput]:
    """DDPM ancestral sampling from t = T-1 down to 0."""
    x, noise = _draws(schedule, shape, x_init, noise, generator, device)
    T = schedule.num_timesteps
    out = None
    for i in range(T):
        t = torch.full((shape[0],), T - 1 - i, dtype=torch.long,
                       device=x.device)
        mean, _, log_variance, _, out = p_mean_variance(
            schedule, model_fn, x, t, clip_denoised=clip_denoised)
        x = (mean + _nonzero_mask(t, x.dim()) * torch.exp(0.5 * log_variance)
             * noise[i])
    return x, out


def ddim_sample_loop(schedule: Schedule, model_fn: DenoiseFn,
                     shape: Tuple[int, ...],
                     generator: Optional[torch.Generator] = None,
                     x_init: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     clip_denoised: bool = True, eta: float = 0.0,
                     device=None) -> Tuple[torch.Tensor, DenoiserOutput]:
    """DDIM sampling (reference ``ddim_sample``, ``gaussian_diffusion.py:
    761-811``); ``eta`` = 0 is deterministic apart from ``x_init``."""
    x, noise = _draws(schedule, shape, x_init, noise, generator, device)
    T = schedule.num_timesteps
    out = None
    for i in range(T):
        t = torch.full((shape[0],), T - 1 - i, dtype=torch.long,
                       device=x.device)
        _, _, _, pred_xstart, out = p_mean_variance(
            schedule, model_fn, x, t, clip_denoised=clip_denoised)
        nd = x.dim()
        eps = predict_eps_from_xstart(schedule, x, t, pred_xstart)
        alpha_bar = extract(schedule.alphas_cumprod, t, nd)
        alpha_bar_prev = extract(schedule.alphas_cumprod_prev, t, nd)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        mean_pred = (pred_xstart * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        x = mean_pred + _nonzero_mask(t, nd) * sigma * noise[i]
    return x, out
