"""Beta schedules and the per-timestep diffusion coefficient table.

Counterpart of ``lsdm_tpu/diffusion/schedule.py``.  As in the reference
(``diffusion/gaussian_diffusion.py:165-204``) every table is computed in
float64 numpy on the host, then cast to float32 tensors on the target
device.  Respacing (reference ``diffusion/respace.py``) is a different
table over the kept timesteps plus a ``timestep_map`` to the original
indices the model conditions on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Set, Union

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int,
                            scale_betas: float = 1.0) -> np.ndarray:
    """Named beta schedule, float64 (reference ``gaussian_diffusion.py:22-46``)."""
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02,
                           num_diffusion_timesteps, dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into betas
    (reference ``gaussian_diffusion.py:49-66``)."""
    t = np.arange(num_diffusion_timesteps, dtype=np.float64)
    ab1 = np.array([alpha_bar(x) for x in t / num_diffusion_timesteps])
    ab2 = np.array([alpha_bar(x) for x in (t + 1) / num_diffusion_timesteps])
    return np.minimum(1.0 - ab2 / ab1, max_beta)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-timestep coefficients, float32 tensors of shape (T,); field
    names are the reference's attribute names."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    # original-process timestep of each (respaced) index; int64
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def _schedule_from_betas(betas: np.ndarray, timestep_map: np.ndarray,
                         device: Optional[torch.device]) -> Schedule:
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D table in (0, 1]")
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(
            np.append(posterior_variance[1], posterior_variance[1:]))),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
            / (1.0 - alphas_cumprod)),
        timestep_map=torch.as_tensor(np.asarray(timestep_map, np.int64),
                                     device=device),
    )


def make_schedule(schedule_name: str = "cosine", num_timesteps: int = 1000,
                  scale_betas: float = 1.0,
                  device: Optional[torch.device] = None) -> Schedule:
    """Full (un-respaced) schedule."""
    betas = get_named_beta_schedule(schedule_name, num_timesteps, scale_betas)
    return _schedule_from_betas(betas, np.arange(num_timesteps), device)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Subset of original timesteps to keep (reference ``respace.py:8-61``):
    ``"ddimN"`` (fixed stride) or per-section counts."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired_count} steps "
                             "with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into "
                             f"{section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def spaced_schedule(schedule_name: str = "cosine", num_timesteps: int = 1000,
                    respacing: Union[str, Sequence[int], None] = None,
                    scale_betas: float = 1.0,
                    device: Optional[torch.device] = None) -> Schedule:
    """Schedule over a kept-timestep subset; betas recomputed as in
    reference ``SpacedDiffusion.__init__`` (``respace.py:64-92``)."""
    if not respacing:
        respacing = [num_timesteps]
    base = get_named_beta_schedule(schedule_name, num_timesteps, scale_betas)
    use_timesteps = space_timesteps(num_timesteps, respacing)
    last = 1.0
    new_betas, timestep_map = [], []
    for i, alpha_cumprod in enumerate(np.cumprod(1.0 - base)):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last)
            last = alpha_cumprod
            timestep_map.append(i)
    return _schedule_from_betas(np.array(new_betas), np.array(timestep_map),
                                device)


def extract(coefs: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-batch coefficients coefs[t] shaped to broadcast over an
    ``ndim``-rank tensor (reference ``_extract_into_tensor``)."""
    out = coefs[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))
