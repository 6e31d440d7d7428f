"""The SDM family: what the benchmark needs of one model to drive the port
(``lsdm_tpu_torch``) and to check it against the plain reference.

Weights come from the seed on the device in three large calls, as the
published state dict (``reference/sdm.py:param_spec``), and are loaded into
the port's model as they are handed to the reference.  The port is driven
through its public entry points only: ``models.sampling.sample_sdm`` (as
``run/test_sdm.py`` calls it) and ``train.trainer.make_train_step`` (as
``run/train_sdm.py`` does).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch

from perfbench.peaks import PEAK_FLOPS
from perfbench.reference import sdm as ref
from perfbench.reference import sdm_counts as counts
from perfbench.seeds import sub_seed


def widths(cfg: dict) -> ref.Widths:
    return ref.widths_of(cfg["model"])


def precision(cfg: dict, control: bool = False) -> ref.Precision:
    """The reference's precision for ``cfg``; with ``control``, the nearest
    precision below it (float32 -> TF32, which the caller switches on;
    bfloat16 -> fp8 products)."""
    dtype = cfg["model"]["dtype"]
    return ref.Precision(dtype, fp8=control and dtype == "bfloat16")


# ----------------------------------------------------------------------
# weights


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's state dict from ``seed``: uniform draws at each layer's
    bound in one generator call on the device, the norms at unit scale and
    zero shift, fresh running statistics."""
    spec = ref.param_spec(widths(cfg))
    drawn, bounds, last = [], [], 1.0
    for name, shape, kind in spec:
        if kind == "linear":
            last = 1.0 / float(torch.Size(shape)[1:].numel()) ** 0.5
        if kind in ("linear", "linear_bias", "xavier"):
            bound = last if kind != "xavier" else (6.0 / (shape[0] + shape[1])) ** 0.5
            drawn.append((name, shape))
            bounds.append(bound)
    sizes = [torch.Size(s).numel() for _, s in drawn]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    flat *= torch.repeat_interleave(torch.tensor(bounds, device=device),
                                    torch.tensor(sizes, device=device))
    sd = {name: part.view(shape) for (name, shape), part
          in zip(drawn, torch.split(flat, sizes))}
    for name, shape, kind in spec:
        if kind in ("ones", "stat_ones"):
            sd[name] = torch.ones(shape, device=device)
        elif kind in ("zeros", "stat_zeros"):
            sd[name] = torch.zeros(shape, device=device)
        elif kind == "count":
            sd[name] = torch.zeros((), dtype=torch.long, device=device)
        elif kind == "pe":
            sd[name] = ref.positional_encoding(shape[-1], shape[0]).to(device)
    return {name: sd[name] for name, _, _ in spec}


# ----------------------------------------------------------------------
# the port


def _port_config(cfg: dict, **over):
    from lsdm_tpu_torch.config import SDMConfig

    fields = {f.name for f in dataclasses.fields(SDMConfig)}
    return SDMConfig(**{k: v for k, v in cfg["model"].items() if k in fields}, **over)


def port_sampler(cfg: dict, sd, traffic: dict, device):
    """(model, schedule, fused_step): the port's model on the sampling
    configuration its entry point resolves for ``device``, with ``sd``."""
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import resolve_fast_path
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel

    d = cfg["diffusion"]
    if d["sampler"] != "ddpm" or d["clip_denoised"]:
        raise NotImplementedError("the benchmark samples DDPM without clipping")
    ball_impl, fused_step = resolve_fast_path("auto", traffic.get("fused_step"), device)
    model = SceneDiffusionModel(_port_config(cfg, ball_impl=ball_impl))
    model = model.to(device).eval()
    model.load_state_dict(sd, strict=True)
    schedule = make_schedule(cfg["diffusion"]["noise_schedule"], cfg["diffusion"]["steps"],
                             device=device)
    return model, schedule, fused_step


def port_sample(model, schedule, fused_step, inputs, generator):
    """One request through ``sample_sdm``: (sample, last DenoiserOutput)."""
    from lsdm_tpu_torch.models.sampling import sample_sdm

    return sample_sdm(model, schedule, inputs["mask"], inputs["objs"], inputs["cats"],
                      inputs["text"], generator=generator, fused_step=fused_step)


def port_trainer(cfg: dict, sd, traffic: dict, device):
    """(state, step): the port's train state (model and AdamW) on
    ``train_sdm``'s configuration for ``device``, and its train step."""
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import resolve_train_attn_impl
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.train.state import create_train_state
    from lsdm_tpu_torch.train.trainer import make_train_step

    model = SceneDiffusionModel(_port_config(
        cfg, ball_impl="auto", attn_impl=resolve_train_attn_impl("auto", device)))
    model = model.to(device)
    model.load_state_dict(sd, strict=True)
    opt, d = cfg["train"], cfg["diffusion"]
    state = create_train_state(model, opt["lr"], opt["weight_decay"])
    schedule = make_schedule(d["noise_schedule"], d["steps"], device=device)
    return state, make_train_step(schedule, d["lambda_cat"])


def wrap_encode(model, hook):
    """Route ``model``'s public ``encode_conditioning`` through ``hook(fn,
    *args, **kwargs)``, on this instance only."""
    inner = model.encode_conditioning

    def encode_conditioning(*args, **kwargs):
        return hook(inner, *args, **kwargs)

    model.encode_conditioning = encode_conditioning


# ----------------------------------------------------------------------
# the reference


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 products (the float32 configurations' control) while inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _control(cfg: dict, control: bool):
    return _tf32(control and cfg["model"]["dtype"] == "float32")


@torch.no_grad()
def reference_sample(cfg: dict, sd, inputs, generator, control: bool = False):
    """(sample, x0, cat, guiding) of the plain reference for one request,
    with the draws ``sample_sdm`` takes from ``generator``: the first image,
    then the T noise tables."""
    w = widths(cfg)
    T = cfg["diffusion"]["steps"]
    B, _, N, _ = inputs["objs"].shape
    dev = inputs["objs"].device
    x_init = torch.randn((B, N, 3), generator=generator, device=dev)
    noise = torch.randn((T, B, N, 3), generator=generator, device=dev)
    with _control(cfg, control):
        return ref.sample(precision(cfg, control), sd, w, T, inputs["mask"], inputs["objs"],
                          inputs["cats"], inputs["text"], x_init, noise)


def reference_train(cfg: dict, sd, steps: List[tuple], control: bool = False):
    """(losses, first gradients, parameters after the steps) of the plain
    reference following ``steps`` from ``sd``."""
    with _control(cfg, control):
        return ref.train_steps(precision(cfg, control), sd, widths(cfg),
                               cfg["diffusion"]["steps"], steps, cfg["diffusion"]["lambda_cat"],
                               cfg["train"])


def trained_names(cfg: dict) -> List[str]:
    return [n for n, _, kind in ref.param_spec(widths(cfg)) if ref.is_param(kind)]


# ----------------------------------------------------------------------
# work


def sample_flops(cfg: dict, B: int) -> int:
    return counts.sample_flops(widths(cfg), B, cfg["diffusion"]["steps"])


def loop_flops(cfg: dict, B: int) -> int:
    return counts.loop_flops(widths(cfg), B, cfg["diffusion"]["steps"])


def loop_bytes(cfg: dict, B: int) -> int:
    return counts.loop_bytes(widths(cfg), B, cfg["diffusion"]["steps"])


def train_flops(cfg: dict, B: int) -> int:
    return counts.train_flops(widths(cfg), B)


def peak_flops(cfg: dict) -> float:
    return PEAK_FLOPS[cfg["model"]["dtype"]]
