"""DDPM posterior math for sampling, and the training loss.

Counterpart of the sampling and training subset of
``lsdm_tpu/diffusion/gaussian.py`` (reference
``diffusion/gaussian_diffusion.py``).  LSDM's model predicts x_start and
uses the fixed small posterior variance (``util/model_util.py:127-163``);
those are the only branches here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from lsdm_tpu_torch.diffusion.schedule import Schedule, extract
from lsdm_tpu_torch.ops.chamfer import chamfer_distance_kernel
from lsdm_tpu_torch.ops.pointcloud import chamfer_distance


@dataclasses.dataclass(frozen=True)
class DenoiserOutput:
    """One denoiser forward: the x_start prediction, the category
    distribution and the guiding points."""

    x0: torch.Tensor  # (B, N, 3)
    cat: torch.Tensor  # (B, 1, max_cats) softmax probabilities
    guiding: Optional[torch.Tensor] = None  # (B, N, 3)


DenoiseFn = Callable[[torch.Tensor, torch.Tensor], DenoiserOutput]


def q_sample(schedule: Schedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """A draw of q(x_t | x_0) (reference ``gaussian_diffusion.py:238-256``)."""
    nd = x_start.dim()
    return (extract(schedule.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(schedule.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


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


def training_losses(schedule: Schedule, model_fn: DenoiseFn,
                    x_start: torch.Tensor, t: torch.Tensor,
                    target_cat: torch.Tensor, noise: torch.Tensor,
                    lambda_cat: float = 0.1, chamfer_impl: str = "xla"
                    ) -> Dict[str, torch.Tensor]:
    """LSDM training loss (reference ``gaussian_diffusion.py:1256-1342``):
    ``chamfer(x0, x_start) + lambda_cat * CE(out_cat, argmax target_cat)``.

    Reference quirk kept on purpose: ``predict_cat`` ends in a softmax and
    the CE applies ``log_softmax`` to those probabilities again.
    ``chamfer_impl``: ``"xla"`` the plain chamfer
    (``ops/pointcloud.py:chamfer_distance``), ``"pallas"`` the K11 loss
    (``ops/chamfer.py``) where the cloud has a multiple of 128 points, the
    JAX function's gate.  Returns ``loss``, ``mse`` (the chamfer) and
    ``cat_loss``."""
    if chamfer_impl not in ("xla", "pallas"):
        raise ValueError(f"chamfer_impl {chamfer_impl!r}: 'xla' or 'pallas'")
    x_t = q_sample(schedule, x_start, t, noise)
    model_out = model_fn(x_t, t)
    log_probs = torch.log_softmax(model_out.cat[:, 0], dim=-1)
    target_idx = target_cat.argmax(dim=1)
    cat_loss = lambda_cat * -log_probs.gather(1, target_idx[:, None]).mean()
    x0, target = model_out.x0.float(), x_start.float()
    if chamfer_impl == "pallas" and x_start.shape[1] % 128 == 0:
        mse = chamfer_distance_kernel(x0, target)
    else:
        mse = chamfer_distance(x0, target)
    return {"loss": mse + cat_loss, "mse": mse, "cat_loss": cat_loss}
