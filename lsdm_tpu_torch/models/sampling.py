"""SDM sampling: conditioning encoded once, then the T-step denoise loop.

Counterpart of ``lsdm_tpu/models/sampling.py`` (``resolve_fast_path`` and
``sample_sdm``).  Only the t/x_t-dependent tail of the model runs inside
the loop; the conditioning (both backbones, both attentions) is encoded
once per sample, through the fused encode kernels when the model's
``ball_impl`` is ``"fused"``.  With ``fused_step="chain"`` the whole loop
is the K6 kernel (``ops/denoise.py``); with ``None`` it is the composed
Python loop of ``diffusion/sampler.py`` calling
:meth:`SceneDiffusionModel.denoise_from_cond` each step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lsdm_tpu_torch.diffusion.gaussian import DenoiserOutput
from lsdm_tpu_torch.diffusion.sampler import ddim_sample_loop, p_sample_loop
from lsdm_tpu_torch.diffusion.schedule import Schedule
from lsdm_tpu_torch.models.sdm import CondCache, SceneDiffusionModel
from lsdm_tpu_torch.ops.denoise import extract_step_params, fused_denoise_chain


def resolve_fast_path(ball_impl: str = "auto",
                      fused_step: Optional[str] = None,
                      device: Optional[torch.device] = None
                      ) -> Tuple[str, Optional[str]]:
    """Resolve the eval-time (``ball_impl``, ``fused_step``) for ``device``,
    as the JAX resolver does for its backend.

    On CUDA, ``ball_impl="auto"`` resolves to ``"fused"`` (the fused encode:
    K7, K8, K4, with K3) and ``fused_step`` ``None``/``"auto"`` to
    ``"chain"`` (the whole-loop kernel K6).  On the CPU they resolve to
    ``"auto"`` (the composed encode, selection by the plain versions) and
    ``None`` (the composed loop).  ``fused_step="none"`` forces the
    composed loop; explicit choices pass through.  Entry points resolve
    before they build the model's config; ``SDMConfig(ball_impl="auto")``
    inside the model keeps meaning the ``"pallas"`` selection.
    """
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if ball_impl == "auto" and on_cuda:
        ball_impl = "fused"
    if fused_step in (None, "auto"):
        fused_step = "chain" if on_cuda else None
    elif fused_step == "none":
        fused_step = None
    elif fused_step != "chain":
        raise NotImplementedError(
            f"fused_step={fused_step!r} is not ported (only 'chain' and "
            "the composed loop)")
    return ball_impl, fused_step


def resolve_train_attn_impl(attn_impl: str = "auto",
                            device: Optional[torch.device] = None) -> str:
    """The train-time ``pcd_attention`` for ``device``: ``"auto"`` becomes
    ``"pallas"`` (K4 forward, K5 backward) on CUDA and ``"xla"`` (the
    composed formulation) on the CPU, as the JAX resolver does."""
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if attn_impl == "auto":
        return "pallas" if on_cuda else "xla"
    return attn_impl


def _encode(model: SceneDiffusionModel, mask, given_objs, given_cats,
            text_emb, cond_chunk: Optional[int]) -> CondCache:
    B = given_objs.shape[0]
    if not cond_chunk or B <= cond_chunk:
        return model.encode_conditioning(mask, given_objs, given_cats, text_emb)
    # bounds the backbone's grouped activations, which peak per scene
    parts = [model.encode_conditioning(mask[i:i + cond_chunk],
                                       given_objs[i:i + cond_chunk],
                                       given_cats[i:i + cond_chunk],
                                       text_emb[i:i + cond_chunk])
             for i in range(0, B, cond_chunk)]
    return CondCache(*(torch.cat(f, dim=0) for f in zip(*parts)))


def chain_coefficients(schedule: Schedule, use_ddim: bool, eta: float = 0.0
                       ) -> torch.Tensor:
    """The (T, 3) table [c1, c2, c3] of loop iteration i (timestep
    t = T-1-i): x_{t-1} = c1 * x0 + c2 * x_t + c3 * noise.

      DDPM: c1, c2 = posterior mean coefficients,
            c3 = (t != 0) * exp(0.5 * posterior log variance);
      DDIM: with q = sqrt(1 - abar_prev - sigma^2),
            c1 = sqrt(abar_prev) - q / rm1, c2 = q * r / rm1,
            c3 = (t != 0) * sigma  (r, rm1: the eps-from-x0 coefficients).
    """
    T = schedule.num_timesteps
    t_seq = torch.arange(T - 1, -1, -1, device=schedule.betas.device)
    nzm = (t_seq != 0).float()
    if use_ddim:
        ab = schedule.alphas_cumprod[t_seq]
        abp = schedule.alphas_cumprod_prev[t_seq]
        r = schedule.sqrt_recip_alphas_cumprod[t_seq]
        rm1 = schedule.sqrt_recipm1_alphas_cumprod[t_seq]
        sigma = (eta * torch.sqrt((1 - abp) / (1 - ab))
                 * torch.sqrt(1 - ab / abp))
        q = torch.sqrt(1 - abp - sigma ** 2)
        return torch.stack([torch.sqrt(abp) - q / rm1, q * r / rm1,
                            nzm * sigma], dim=-1)
    return torch.stack([
        schedule.posterior_mean_coef1[t_seq],
        schedule.posterior_mean_coef2[t_seq],
        torch.exp(0.5 * schedule.posterior_log_variance_clipped[t_seq]) * nzm,
    ], dim=-1)


@torch.no_grad()
def sample_sdm(
    model: SceneDiffusionModel,
    schedule: Schedule,
    mask: torch.Tensor,  # (B, max_objs)
    given_objs: torch.Tensor,  # (B, max_objs, N, 3)
    given_cats: torch.Tensor,  # (B, max_objs, max_cats)
    text_emb: torch.Tensor,  # (B, clip_dim)
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = False,
    use_ddim: bool = False,
    timestep_map: Optional[torch.Tensor] = None,
    cond_chunk: Optional[int] = None,
    fused_step: Optional[str] = None,
    x_init: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, DenoiserOutput]:
    """Returns (sample (B, N, 3), DenoiserOutput of the last step).

    ``x_init`` (B, N, 3) and ``noise`` (T, B, N, 3) inject the draws;
    what is not given comes from ``generator``.  ``timestep_map`` maps
    loop timesteps to the model's (respaced schedules).  ``cond_chunk``
    encodes the conditioning in batch chunks of that size.
    """
    if model.training:  # JAX samples with train=False
        raise ValueError("sample_sdm needs the model in eval mode (model.eval()): "
                         "training mode normalises with batch statistics and "
                         "drops out")
    B, _, N, _ = given_objs.shape
    dev = given_objs.device
    T = schedule.num_timesteps
    cond = _encode(model, mask, given_objs, given_cats, text_emb, cond_chunk)
    ts_model = (timestep_map if timestep_map is not None
                else torch.arange(T, device=dev))
    if x_init is None:
        x_init = torch.randn((B, N, 3), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn((T, B, N, 3), generator=generator, device=dev)

    if fused_step == "chain":
        t_seq = torch.arange(T - 1, -1, -1, device=dev)
        tm_seq = ts_model[t_seq]
        final, last_in = fused_denoise_chain(
            x_init.contiguous(), noise.transpose(0, 1).contiguous(),
            cond.cond_pcd.contiguous(),
            model.step_emb2_table(cond, tm_seq).contiguous(),
            chain_coefficients(schedule, use_ddim).contiguous(),
            extract_step_params(model), clip_denoised=clip_denoised)
        # the DenoiserOutput at the last step's input, composed
        last_out = model.denoise_from_cond(
            cond, last_in, tm_seq[-1].expand(B))
        return final, last_out
    if fused_step is not None:
        raise NotImplementedError(f"fused_step={fused_step!r} is not ported")

    def model_fn(x_t, t):
        return model.denoise_from_cond(cond, x_t, ts_model[t])

    loop = ddim_sample_loop if use_ddim else p_sample_loop
    return loop(schedule, model_fn, (B, N, 3), x_init=x_init, noise=noise,
                clip_denoised=clip_denoised)
