"""Weights of the port's SceneDiffusionModel: a seeded initialisation,
and the bridge from the JAX package's parameter and optimizer trees.

:func:`state_dict_from_jax` is the exact inverse of
``lsdm_tpu/train/checkpoint.py:convert_torch_state_dict``: it turns the
JAX ``params``/``batch_stats`` trees (as numpy arrays) into the port's
``state_dict``, whose keys are the reference torch model's.  Flax Dense
kernels (in, out) become (out, in) conv weights with trailing 1x1 dims,
``scale`` becomes ``weight`` and ``mean``/``var`` become
``running_mean``/``running_var``.  :func:`load_adamw_state_from_optax`
carries optax's Adam moments (``ScaleByAdamState``: mu, nu, count) over
to ``torch.optim.AdamW``'s state, so both optimizers can start from the
same point.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from lsdm_tpu_torch.models.common import PositionalEncoding
from lsdm_tpu_torch.models.pointnet2 import Conv1x1
from lsdm_tpu_torch.ops.attention import TorchMultiheadAttention


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and statistic of ``model`` from one seeded
    generator, in module order (deterministic for a given seed).

    Linear and 1x1 conv weights and biases draw U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) as torch's defaults do; attention projections are
    Xavier-uniform with zero in-projection bias; norms start at unit scale
    and zero shift with zero-mean, unit-variance running statistics.
    """
    g = torch.Generator().manual_seed(seed)

    def uniform_(t: torch.Tensor, bound: float) -> None:
        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (nn.Linear, Conv1x1)):
            bound = m.weight[0].numel() ** -0.5
            uniform_(m.weight, bound)
            uniform_(m.bias, bound)
        elif isinstance(m, TorchMultiheadAttention):
            for w in (m.q_proj_weight, m.k_proj_weight, m.v_proj_weight):
                uniform_(w, (6.0 / (w.shape[0] + w.shape[1])) ** 0.5)
            m.in_proj_bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
    return model


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _conv(spatial_dims: int):
    # flax Dense kernel (in, out) -> torch conv weight (out, in, 1[, 1])
    return lambda v: v.T.reshape(v.shape[1], v.shape[0], *([1] * spatial_dims))


# (pattern on the dotted JAX path, replacement, value transform or None)
_PARAM_RULES = (
    (r"embed_timestep\.time_embed_(\d)\.(weight|bias)",
     r"embed_timestep.time_embed.\1.\2", None),
    (r"human_backbone\.de_spiral_(\d)\.norm\.scale",
     r"human_backbone.de_spiral.\1.norm.weight", None),
    (r"human_backbone\.de_spiral_(\d)\.(.+)",
     r"human_backbone.de_spiral.\1.\2", None),
    (r"pcd_backbone\.(sa\d)\.mlp_(\d)\.conv\.kernel",
     r"pcd_backbone.\1.mlp_convs.\2.weight", _conv(2)),
    (r"pcd_backbone\.(fp\d)\.mlp_(\d)\.conv\.kernel",
     r"pcd_backbone.\1.mlp_convs.\2.weight", _conv(1)),
    (r"pcd_backbone\.((?:sa|fp)\d)\.mlp_(\d)\.conv\.bias",
     r"pcd_backbone.\1.mlp_convs.\2.bias", None),
    (r"pcd_backbone\.((?:sa|fp)\d)\.mlp_(\d)\.bn\.scale",
     r"pcd_backbone.\1.mlp_bns.\2.weight", None),
    (r"pcd_backbone\.((?:sa|fp)\d)\.mlp_(\d)\.bn\.bias",
     r"pcd_backbone.\1.mlp_bns.\2.bias", None),
    (r"pcd_backbone\.head\.conv\.kernel", "pcd_backbone.conv1.weight", _conv(1)),
    (r"pcd_backbone\.head\.conv\.bias", "pcd_backbone.conv1.bias", None),
    (r"pcd_backbone\.head\.bn\.scale", "pcd_backbone.bn1.weight", None),
    (r"pcd_backbone\.head\.bn\.bias", "pcd_backbone.bn1.bias", None),
    (r"pcd_backbone\.conv2\.kernel", "pcd_backbone.conv2.weight", _conv(1)),
    (r"pcd_backbone\.conv2\.bias", "pcd_backbone.conv2.bias", None),
    # MLPs, attentions, input/output process: the dotted path is the key
    (r"(.+)", r"\1", None),
)
_STAT_RULES = (
    (r"pcd_backbone\.((?:sa|fp)\d)\.mlp_(\d)\.bn\.(mean|var)",
     r"pcd_backbone.\1.mlp_bns.\2.running_\3"),
    (r"pcd_backbone\.head\.bn\.(mean|var)", r"pcd_backbone.bn1.running_\1"),
)


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's parameters, by ``named_parameters`` name, from a tree
    shaped like JAX's ``variables["params"]`` (the parameters themselves,
    their gradients or an optimizer's moments)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        for pattern, repl, fn in _PARAM_RULES:
            if re.fullmatch(pattern, path):
                val = v if fn is None else fn(v)
                sd[re.sub(pattern, repl, path)] = torch.from_numpy(
                    np.ascontiguousarray(val, dtype=np.float32))
                break
    return sd


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a JAX ``SceneDiffusionModel``'s
    ``variables["params"]`` and ``variables["batch_stats"]`` (nested
    mappings of arrays), ready for a strict ``load_state_dict``."""
    sd = params_from_jax(params)
    for path, v in _flatten(batch_stats).items():
        for pattern, repl in _STAT_RULES:
            if re.fullmatch(pattern, path):
                sd[re.sub(pattern, repl, path)] = torch.from_numpy(
                    np.ascontiguousarray(v, dtype=np.float32))
                break
        else:
            raise KeyError(f"unmapped batch statistic: {path}")
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    if "embed_timestep.time_embed.0.weight" in sd:  # a whole model's tree
        D = sd["embed_timestep.time_embed.0.weight"].shape[0]
        sd["sequence_pos_encoder.pe"] = PositionalEncoding(D).pe
    return sd


@torch.no_grad()
def load_adamw_state_from_optax(optimizer: torch.optim.Optimizer,
                                model: nn.Module, mu: Mapping, nu: Mapping,
                                count: int) -> None:
    """Set ``optimizer``'s (``torch.optim.AdamW`` over ``model``'s
    parameters) state to optax's ``ScaleByAdamState(count, mu, nu)``, the
    moment trees as numpy arrays: ``exp_avg = mu``, ``exp_avg_sq = nu``,
    ``step = count``."""
    m, v = params_from_jax(mu), params_from_jax(nu)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": m[name].to(p.device).reshape(p.shape).clone(),
            "exp_avg_sq": v[name].to(p.device).reshape(p.shape).clone()}
