"""DDPM posterior math for sampling.

Counterpart of the sampling subset of ``lsdm_tpu/diffusion/gaussian.py``
(reference ``diffusion/gaussian_diffusion.py``).  LSDM's model predicts
x_start and uses the fixed small posterior variance
(``util/model_util.py:127-163``); those are the only branches here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from lsdm_tpu_torch.diffusion.schedule import Schedule, extract


@dataclasses.dataclass(frozen=True)
class DenoiserOutput:
    """One denoiser forward: the x_start prediction, the category
    distribution and the guiding points."""

    x0: torch.Tensor  # (B, N, 3)
    cat: torch.Tensor  # (B, 1, max_cats) softmax probabilities
    guiding: Optional[torch.Tensor] = None  # (B, N, 3)


DenoiseFn = Callable[[torch.Tensor, torch.Tensor], DenoiserOutput]


def q_posterior_mean_variance(schedule: Schedule, x_start: torch.Tensor,
                              x_t: torch.Tensor, t: torch.Tensor):
    """q(x_{t-1} | x_t, x_0) (reference ``gaussian_diffusion.py:258-280``)."""
    nd = x_t.dim()
    mean = (extract(schedule.posterior_mean_coef1, t, nd) * x_start
            + extract(schedule.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(schedule.posterior_variance, t, nd),
            extract(schedule.posterior_log_variance_clipped, t, nd))


def predict_xstart_from_eps(schedule: Schedule, x_t, t, eps):
    """(reference ``gaussian_diffusion.py:395-400``)"""
    nd = x_t.dim()
    return (extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_eps_from_xstart(schedule: Schedule, x_t, t, pred_xstart):
    """(reference ``gaussian_diffusion.py:411-416``)"""
    nd = x_t.dim()
    return ((extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t
             - pred_xstart)
            / extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd))


def p_mean_variance(schedule: Schedule, model_fn: DenoiseFn, x: torch.Tensor,
                    t: torch.Tensor, clip_denoised: bool = True):
    """p(x_{t-1} | x_t) for the x_start-predicting, fixed-small-variance
    model (reference ``gaussian_diffusion.py:282-393``).  Returns
    (mean, variance, log_variance, pred_xstart, model_out)."""
    model_out = model_fn(x, t)
    nd = x.dim()
    variance = extract(schedule.posterior_variance, t, nd)
    log_variance = extract(schedule.posterior_log_variance_clipped, t, nd)
    pred_xstart = model_out.x0
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    mean, _, _ = q_posterior_mean_variance(schedule, pred_xstart, x, t)
    return mean, variance, log_variance, pred_xstart, model_out
