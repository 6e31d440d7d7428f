"""SDM sampling: conditioning encoded once, then the T-step denoise loop.

Counterpart of ``lsdm_tpu/models/sampling.py`` (``resolve_fast_path`` and
``sample_sdm``).  Only the t/x_t-dependent tail of the model runs inside
the loop; the conditioning (both backbones, both attentions) is encoded
once per sample, through the fused encode kernels when the model's
``ball_impl`` is ``"fused"``.  With ``fused_step="chain"`` the whole loop
is the K6 kernel (``ops/denoise.py``); with ``"step"`` a host loop calls
the K9 kernel once per step (JAX ``_sample_fused``, mode ``"step"``); with
``None`` it is the composed Python loop of ``diffusion/sampler.py``
calling :meth:`SceneDiffusionModel.denoise_from_cond` each step.  A bf16
model (``SDMConfig.dtype``) samples on every path in bf16: its fused
encode runs K7's and K8's bf16 modes, and K6 and K9 run theirs, as the JAX
sampler passes ``compute_dtype=model.cfg.dtype`` to them.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import torch

from lsdm_tpu_torch.diffusion.gaussian import DenoiserOutput
from lsdm_tpu_torch.diffusion.sampler import ddim_sample_loop, p_sample_loop
from lsdm_tpu_torch.diffusion.schedule import Schedule
from lsdm_tpu_torch.models.sdm import CondCache, SceneDiffusionModel
from lsdm_tpu_torch.ops.denoise import (
    fused_denoise_chain, make_denoise_step_loop, step_params, step_params_key)
from lsdm_tpu_torch.parallel.mesh import (
    BatchShard, Mesh, all_gather, batch_sharding, shard_batch)

# the step sampler's loops (on CUDA, captured CUDA graphs), per model: key
# (factory, B, N, T, clip, compute dtype, weights) -> the loop
_STEP_LOOPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def step_loop(model: SceneDiffusionModel, B: int, N: int, T: int,
              device: torch.device, clip_denoised: bool):
    """The K9 loop of ``make_denoise_step_loop`` for ``model``'s weights as
    they stand, in the model's compute dtype, built once and kept per (B,
    N, T, clip, weights): on CUDA a second sample with the same shapes
    replays the graph the first captured.  A loop of the same shapes over
    older weights is dropped."""
    factory = make_denoise_step_loop  # the module's, as it stands
    dt = model.compute_dtype
    weights = step_params_key(model)
    loops = _STEP_LOOPS.setdefault(model, {})
    key = (factory, B, N, T, bool(clip_denoised), dt, weights)
    if key not in loops:
        for k in [k for k in loops if k[:6] == key[:6]]:
            del loops[k]
        loops[key] = factory(step_params(model, dt), B, N, T, device,
                             clip_denoised, dt)
    return loops[key]


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
    composed loop; explicit choices (``"chain"``, ``"step"``: K9 once per
    step) pass through.  Entry points resolve
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
    elif fused_step not in ("chain", "step"):
        raise ValueError(f"fused_step={fused_step!r}: expected 'auto', "
                         "'chain', 'step' or 'none'")
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
            text_emb, cond_chunk: Optional[int],
            shard: Optional[BatchShard] = None) -> CondCache:
    B = given_objs.shape[0]
    if shard is not None:  # this rank's scenes, in one piece
        return model.encode_conditioning(mask, given_objs, given_cats, text_emb,
                                         shard=shard)
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
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, DenoiserOutput]:
    """Returns (sample (B, N, 3), DenoiserOutput of the last step).

    ``x_init`` (B, N, 3) and ``noise`` (T, B, N, 3) inject the draws;
    what is not given comes from ``generator``.  ``timestep_map`` maps
    loop timesteps to the model's (respaced schedules).  ``cond_chunk``
    encodes the conditioning in batch chunks of that size.

    With a ``mesh`` (``parallel/mesh.py``) every rank of it calls this with
    the global batch and the same generator (or draws): the draws are taken
    for the global batch, each rank samples its data index's scenes on the
    path it would take alone (a ``BatchShard`` without a cloud split keeps
    the global batch's mask reading; ``cond_chunk`` does not apply), and
    the results are gathered over the data axis, so every rank returns the
    global batch's sample.
    """
    if model.training:  # JAX samples with train=False
        raise ValueError("sample_sdm needs the model in eval mode (model.eval()): "
                         "training mode normalises with batch statistics and "
                         "drops out")
    B, _, N, _ = given_objs.shape
    dev = given_objs.device
    T = schedule.num_timesteps
    if x_init is None:
        x_init = torch.randn((B, N, 3), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn((T, B, N, 3), generator=generator, device=dev)
    if mesh is not None:
        mask, given_objs, given_cats, text_emb, x_init = shard_batch(
            mesh, (mask, given_objs, given_cats, text_emb, x_init))
        sample, last = _sample(
            model, schedule, mask, given_objs, given_cats, text_emb,
            clip_denoised, use_ddim, timestep_map, None, fused_step, x_init,
            noise[:, batch_sharding(mesh, B)], BatchShard(mesh, split_clouds=False))
        gather = lambda t: all_gather(t, mesh.data_group)  # noqa: E731
        return gather(sample), DenoiserOutput(
            x0=gather(last.x0), cat=gather(last.cat), guiding=gather(last.guiding))
    return _sample(model, schedule, mask, given_objs, given_cats, text_emb,
                   clip_denoised, use_ddim, timestep_map, cond_chunk, fused_step,
                   x_init, noise, None)


def _sample(model, schedule, mask, given_objs, given_cats, text_emb,
            clip_denoised, use_ddim, timestep_map, cond_chunk, fused_step,
            x_init, noise, shard) -> Tuple[torch.Tensor, DenoiserOutput]:
    B, _, N, _ = given_objs.shape
    dev = given_objs.device
    T = schedule.num_timesteps
    cond = _encode(model, mask, given_objs, given_cats, text_emb, cond_chunk,
                   shard)
    ts_model = (timestep_map if timestep_map is not None
                else torch.arange(T, device=dev))

    if fused_step in ("chain", "step"):
        t_seq = torch.arange(T - 1, -1, -1, device=dev)
        tm_seq = ts_model[t_seq]
        # (B, T, 2D) and cond_pcd in float32, as the Pallas wrappers cast
        # them (a bf16 model's are bf16, which widen exactly)
        e2_tab = model.step_emb2_table(cond, tm_seq).float()
        coef_tab = chain_coefficients(schedule, use_ddim).contiguous()
        cond_pcd = cond.cond_pcd.float().contiguous()
        # the kernels' mode: the model's compute dtype (JAX passes
        # compute_dtype=model.cfg.dtype)
        dt = model.compute_dtype
        if fused_step == "chain":
            final, last_in = fused_denoise_chain(
                x_init.contiguous(), noise.transpose(0, 1).contiguous(),
                cond_pcd, e2_tab.contiguous(), coef_tab, step_params(model, dt),
                clip_denoised=clip_denoised, compute_dtype=dt)
        else:
            # one K9 call per step, carrying (x, last_in) as the JAX scan
            # does; every step's rows are contiguous rows of the tables,
            # all made before the loop, and the coefficients stay on the
            # device
            run = step_loop(model, B, N, T, dev, clip_denoised)
            final, last_in = run(x_init.contiguous(), noise.contiguous(),
                                 cond_pcd, e2_tab.transpose(0, 1).contiguous(),
                                 coef_tab)
        # the DenoiserOutput at the last step's input, composed
        last_out = model.denoise_from_cond(
            cond, last_in, tm_seq[-1].expand(B))
        return final, last_out
    if fused_step is not None:
        raise ValueError(f"fused_step={fused_step!r}: expected 'chain', "
                         "'step' or None")

    def model_fn(x_t, t):
        return model.denoise_from_cond(cond, x_t, ts_model[t])

    loop = ddim_sample_loop if use_ddim else p_sample_loop
    return loop(schedule, model_fn, (B, N, 3), x_init=x_init, noise=noise,
                clip_denoised=clip_denoised)
