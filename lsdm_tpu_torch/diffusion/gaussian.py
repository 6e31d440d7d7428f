"""DDPM math: the q and p distributions, classifier guidance, the
variational bound in bits per dimension, and the training loss.

Counterpart of ``lsdm_tpu/diffusion/gaussian.py`` (reference
``diffusion/gaussian_diffusion.py`` and ``diffusion/losses.py``).  LSDM's
model predicts x_start and uses the fixed small posterior variance
(``util/model_util.py:127-163``); those are the only branches here.
"""

from __future__ import annotations

import dataclasses
import math
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


def q_mean_variance(schedule: Schedule, x_start: torch.Tensor, t: torch.Tensor):
    """q(x_t | x_0): (mean, variance, log variance) (reference
    ``gaussian_diffusion.py:221-236``)."""
    nd = x_start.dim()
    return (extract(schedule.sqrt_alphas_cumprod, t, nd) * x_start,
            extract(1.0 - schedule.alphas_cumprod, t, nd),
            extract(schedule.log_one_minus_alphas_cumprod, t, nd))


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


def condition_mean(cond_fn: Callable, mean: torch.Tensor, variance: torch.Tensor,
                   x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Classifier guidance of the mean (reference ``condition_mean``,
    ``gaussian_diffusion.py:423-436``): mean + variance * cond_fn(x, t),
    ``cond_fn`` the gradient of log p(y | x)."""
    return mean + variance * cond_fn(x, t).float()


def condition_score(cond_fn: Callable, schedule: Schedule,
                    pred_xstart: torch.Tensor, x: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """Classifier guidance of the score, for DDIM (reference
    ``condition_score``, ``gaussian_diffusion.py:461-480``): the implied
    epsilon shifted by sqrt(1 - abar) * cond_fn(x, t), x_start re-derived."""
    alpha_bar = extract(schedule.alphas_cumprod, t, x.dim())
    eps = predict_eps_from_xstart(schedule, x, t, pred_xstart)
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, t)
    return predict_xstart_from_eps(schedule, x, t, eps)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians (reference ``diffusion/losses.py:12-39``)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """(reference ``diffusion/losses.py:42-47``)"""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to 8-bit bins on [-1, 1]
    (reference ``diffusion/losses.py:50-77``)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_terms_bpd(schedule: Schedule, model_fn: DenoiseFn, x_start: torch.Tensor,
                 x_t: torch.Tensor, t: torch.Tensor, clip_denoised: bool = False):
    """One term of the variational bound in bits per dimension (reference
    ``gaussian_diffusion.py:1221-1254``): KL(q(x_{t-1} | x_t, x_0) ||
    p(x_{t-1} | x_t)), or the decoder NLL at t = 0.  Returns (term (B,),
    pred_xstart)."""
    true_mean, _, true_log_var = q_posterior_mean_variance(schedule, x_start, x_t, t)
    mean, _, log_var, pred_xstart, _ = p_mean_variance(
        schedule, model_fn, x_t, t, clip_denoised=clip_denoised)
    B = x_start.shape[0]
    kl = normal_kl(true_mean, true_log_var, mean, log_var)
    kl = kl.reshape(B, -1).mean(dim=1) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=mean, log_scales=0.5 * log_var)
    decoder_nll = decoder_nll.reshape(B, -1).mean(dim=1) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), pred_xstart


@torch.no_grad()
def calc_bpd_loop(schedule: Schedule, model_fn: DenoiseFn, x_start: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
    """The whole variational bound in bits per dimension (reference
    ``calc_bpd_loop``, ``gaussian_diffusion.py:1527-1583``): each step t
    noises x_start with ``noise[t]`` (a (T, *x_start.shape) table; drawn
    from ``generator`` when not given).  Returns ``total_bpd`` and
    ``prior_bpd`` (B,), and the per-step ``vb`` and ``mse`` (B, T)."""
    B, T = x_start.shape[0], schedule.num_timesteps
    if noise is None:
        noise = torch.randn((T,) + tuple(x_start.shape), generator=generator,
                            device=x_start.device)
    vb, mse = [], []
    for ti in range(T):
        t = torch.full((B,), ti, dtype=torch.long, device=x_start.device)
        x_t = q_sample(schedule, x_start, t, noise[ti])
        term, pred_xstart = vb_terms_bpd(schedule, model_fn, x_start, x_t, t,
                                         clip_denoised=clip_denoised)
        vb.append(term)
        mse.append(((pred_xstart - x_start) ** 2).reshape(B, -1).mean(dim=1))
    vb, mse = torch.stack(vb, dim=1), torch.stack(mse, dim=1)
    # the prior term: KL(q(x_T | x_0) || N(0, I))
    t_last = torch.full((B,), T - 1, dtype=torch.long, device=x_start.device)
    mean, _, log_var = q_mean_variance(schedule, x_start, t_last)
    prior = normal_kl(mean, log_var, torch.zeros_like(mean), torch.zeros_like(log_var))
    prior_bpd = prior.reshape(B, -1).mean(dim=1) / math.log(2.0)
    return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd,
            "vb": vb, "mse": mse}
