"""DDPM ancestral, DDIM and PLMS sampling loops.

Counterpart of ``lsdm_tpu/diffusion/sampler.py`` (reference
``gaussian_diffusion.py:501-1219``) as plain Python loops over the steps.
Each loop takes an optional initial image ``x_init`` (B, ...); the
stochastic loops also take an optional per-step noise table ``noise``
(steps, B, ...), so a caller can feed draws made elsewhere (the parity
tests feed the JAX package's); what is not given is drawn from
``generator``.  Each returns (final sample, last model output).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from lsdm_tpu_torch.diffusion.gaussian import (
    DenoiseFn, DenoiserOutput, condition_mean, p_mean_variance,
    predict_eps_from_xstart, predict_xstart_from_eps, q_sample)
from lsdm_tpu_torch.diffusion.schedule import Schedule, extract


def _draws(steps: int, shape: Tuple[int, ...], x_init: Optional[torch.Tensor],
           noise: Optional[torch.Tensor], generator: Optional[torch.Generator],
           device) -> Tuple[torch.Tensor, torch.Tensor]:
    if x_init is None:
        x_init = torch.randn(shape, generator=generator, device=device)
    if noise is None:
        noise = torch.randn((steps,) + tuple(shape), generator=generator,
                            device=device)
    if tuple(x_init.shape) != tuple(shape) or tuple(noise.shape) != (steps,) + tuple(shape):
        raise ValueError(f"x_init must be {tuple(shape)} and noise "
                         f"{(steps,) + tuple(shape)}")
    return x_init, noise


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    m = (t != 0).float()
    return m.reshape(m.shape + (1,) * (ndim - 1))


def p_sample_step(schedule: Schedule, model_fn: DenoiseFn, x: torch.Tensor,
                  t: torch.Tensor, noise: torch.Tensor, clip_denoised: bool = True,
                  const_noise: bool = False, cond_fn: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, DenoiserOutput]:
    """One ancestral DDPM step (reference ``p_sample``,
    ``gaussian_diffusion.py:501-561``) with the draw ``noise`` (its first
    item for every batch entry with ``const_noise``) and, with
    ``cond_fn(x, t) -> grad log p(y | x)``, classifier guidance of the mean.
    Returns (sample, pred_xstart, model output)."""
    mean, variance, log_variance, pred_xstart, out = p_mean_variance(
        schedule, model_fn, x, t, clip_denoised=clip_denoised)
    if cond_fn is not None:
        mean = condition_mean(cond_fn, mean, variance, x, t)
    if const_noise:
        noise = noise[:1].expand_as(noise)
    sample = mean + _nonzero_mask(t, x.dim()) * torch.exp(0.5 * log_variance) * noise
    return sample, pred_xstart, out


def p_sample_loop(schedule: Schedule, model_fn: DenoiseFn,
                  shape: Tuple[int, ...],
                  generator: Optional[torch.Generator] = None,
                  x_init: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  clip_denoised: bool = True, const_noise: bool = False,
                  skip_timesteps: int = 0,
                  init_image: Optional[torch.Tensor] = None,
                  device=None) -> Tuple[torch.Tensor, DenoiserOutput]:
    """DDPM ancestral sampling from t = T-1-skip_timesteps down to 0.

    With ``skip_timesteps`` the loop starts from ``init_image`` (zeros when
    not given) noised to that step by ``x_init`` (``q_sample``), and runs
    T - skip_timesteps steps, so ``noise`` is (T - skip_timesteps, *shape).
    """
    start_t = schedule.num_timesteps - skip_timesteps
    x, noise = _draws(start_t, shape, x_init, noise, generator, device)
    if skip_timesteps:
        if init_image is None:
            init_image = torch.zeros(shape, device=x.device)
        t = torch.full((shape[0],), start_t - 1, dtype=torch.long, device=x.device)
        x = q_sample(schedule, init_image, t, x)
    out = None
    for i in range(start_t):
        t = torch.full((shape[0],), start_t - 1 - i, dtype=torch.long,
                       device=x.device)
        x, _, out = p_sample_step(schedule, model_fn, x, t, noise[i],
                                  clip_denoised=clip_denoised,
                                  const_noise=const_noise)
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
    T = schedule.num_timesteps
    x, noise = _draws(T, shape, x_init, noise, generator, device)
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


def plms_sample_loop(schedule: Schedule, model_fn: DenoiseFn,
                     shape: Tuple[int, ...],
                     generator: Optional[torch.Generator] = None,
                     x_init: Optional[torch.Tensor] = None,
                     clip_denoised: bool = True, order: int = 2,
                     device=None) -> Tuple[torch.Tensor, DenoiserOutput]:
    """PLMS sampling, Adams-Bashforth of ``order`` 1-4 over the newest
    epsilons (reference ``plms_sample(_loop)``, ``gaussian_diffusion.py:
    1024-1219``); with order > 1 the first step is the pseudo improved
    Euler step, one extra model call.  Deterministic apart from
    ``x_init``."""
    if not 1 <= order <= 4:
        raise ValueError("order must be in [1, 4]")
    T = schedule.num_timesteps
    x = torch.randn(shape, generator=generator, device=device) if x_init is None else x_init

    def model_eps(x, t):
        _, _, _, pred_xstart, out = p_mean_variance(
            schedule, model_fn, x, t, clip_denoised=clip_denoised)
        return predict_eps_from_xstart(schedule, x, t, pred_xstart), pred_xstart, out

    hist = []  # previous epsilons, newest first
    out = None
    for i in range(T):
        t = torch.full((shape[0],), T - 1 - i, dtype=torch.long, device=x.device)
        eps, pred_xstart, out = model_eps(x, t)
        sqrt_abp = torch.sqrt(extract(schedule.alphas_cumprod_prev, t, x.dim()))
        sqrt_1m_abp = torch.sqrt(1 - extract(schedule.alphas_cumprod_prev, t, x.dim()))
        if order > 1 and not hist:
            # pseudo improved Euler (reference gaussian_diffusion.py:1074-1081)
            eps2, _, _ = model_eps(pred_xstart * sqrt_abp + sqrt_1m_abp * eps,
                                   (t - 1).clamp(min=0))
            eps_p = (eps + eps2) / 2
        else:
            # Adams-Bashforth over the newest min(order, steps so far)
            # epsilons, in the JAX function's order of operations
            n = min(len(hist) + 1, order)
            if n == 1:
                eps_p = eps
            elif n == 2:
                eps_p = (3 * eps - hist[0]) / 2
            elif n == 3:
                eps_p = (23 * eps - 16 * hist[0] + 5 * hist[1]) / 12
            else:
                eps_p = (55 * eps - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        pred_p = predict_xstart_from_eps(schedule, x, t, eps_p)
        mean_pred = pred_p * sqrt_abp + sqrt_1m_abp * eps_p
        nzm = _nonzero_mask(t, x.dim())
        x = mean_pred * nzm + pred_xstart * (1 - nzm)
        hist = [eps] + hist[:max(order - 2, 0)]
    return x, out
