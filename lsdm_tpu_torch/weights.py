"""Weights of the port's SceneDiffusionModel: a seeded initialisation,
and the bridge from the JAX package's parameter and optimizer trees.

:func:`state_dict_from_jax` is the exact inverse of
``lsdm_tpu/train/checkpoint.py:convert_torch_state_dict``: it turns the
JAX ``params``/``batch_stats`` trees (as numpy arrays) into the port's
``state_dict``, whose keys are the reference torch model's.  Flax Dense
kernels (in, out) become (out, in) conv weights with trailing 1x1 dims,
``scale`` becomes ``weight`` and ``mean``/``var`` become
``running_mean``/``running_var``.  The DGCNN and STGCN backbones keep the
JAX modules' names: their Dense kernels are transposed, their flax
``Conv`` kernels (kh, kw, in, out) become (out, in, kh, kw) and their
edge importances cross as they are.  :func:`load_adamw_state_from_optax`
carries optax's Adam moments (``ScaleByAdamState``: mu, nu, count) over
to ``torch.optim.AdamW``'s state, so both optimizers can start from the
same point.

:func:`contactformer_state_dict_from_jax` carries a JAX ``ContactFormer``
(or ``POSA``) across: the port keeps the JAX modules' names, so only the
norms' ``scale`` and mode 4's LSTM cells change.

:func:`atiss_state_dict_from_jax` carries a JAX ATISS / MIME / PE model
across to the port's names, the reference torch state_dict's, and
:func:`atiss_state_dict` readies a reference (or the port's own) state
dict for a strict load, dropping what the JAX converter drops.

The text towers' bridges: :func:`clip_text_state_dict` (a torch CLIP text
state dict in OpenAI's or HF's naming, the port's names being OpenAI's)
and :func:`bert_state_dict` (an HF torch BERT checkpoint) for released
weights; :func:`clip_text_state_dict_from_jax` and
:func:`bert_state_dict_from_flax` carry the JAX package's towers across.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from lsdm_tpu_torch.models.atiss import (
    AutoregressiveTransformer, AutoregressiveTransformerPE, MultiheadSelfAttention,
    TorchTransformerEncoderLayer)
from lsdm_tpu_torch.models.common import PositionalEncoding
from lsdm_tpu_torch.models.contactformer import TorchTransformerDecoderLayer
from lsdm_tpu_torch.models.feature_extractors import _BN
from lsdm_tpu_torch.models.pointnet2 import Conv1x1
from lsdm_tpu_torch.models.stgcn import TemporalConv
from lsdm_tpu_torch.ops.attention import TorchMultiheadAttention


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and statistic of ``model`` from one seeded
    generator, in module order (deterministic for a given seed).

    Linear and 1x1 conv weights and biases draw U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) as torch's defaults do; attention projections (the
    ContactFormer's and ATISS's transformer layers' too) are
    Xavier-uniform with zero in-projection bias; an LSTM's weights draw
    U(-1/sqrt(hidden), 1/sqrt(hidden)) with zero biases (flax's cell has
    no input bias); the ATISS extractors' convolutions draw N(0, 2 /
    fan_out) (He, as torchvision's) with zero biases, and ATISS's empty
    token and slot embeddings N(0, 1); norms start at unit scale and zero
    shift with zero-mean, unit-variance running statistics (a frozen
    ATISS BatchNorm at 1 + 1e-5, the eps fold); the STGCN's edge
    importances keep their initial ones, as flax's do.
    """
    g = torch.Generator().manual_seed(seed)

    def uniform_(t: torch.Tensor, bound: float) -> None:
        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (nn.Linear, Conv1x1, TemporalConv)):
            bound = m.weight[0].numel() ** -0.5
            uniform_(m.weight, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, nn.Conv2d):
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * (2.0 / fan_out) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _BN):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(m.init_var)
        elif isinstance(m, AutoregressiveTransformer):
            m.empty_token_embedding.copy_(torch.randn(
                m.empty_token_embedding.shape, generator=g))
            if isinstance(m, AutoregressiveTransformerPE):
                m.positional_embedding.copy_(torch.randn(
                    m.positional_embedding.shape, generator=g))
        elif isinstance(m, (TorchMultiheadAttention, TorchTransformerEncoderLayer,
                            TorchTransformerDecoderLayer, MultiheadSelfAttention)):
            for name, w in m.named_parameters(recurse=False):
                if name.endswith("proj_weight"):
                    uniform_(w, (6.0 / (w.shape[0] + w.shape[1])) ** 0.5)
                else:
                    w.zero_()
        elif isinstance(m, nn.LSTM):
            for name, w in m.named_parameters():
                if name.startswith("weight"):
                    uniform_(w, m.hidden_size ** -0.5)
                else:
                    w.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm1d, nn.LayerNorm)):
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


def _kernel(v: np.ndarray) -> np.ndarray:
    # flax Dense kernel (in, out) -> Linear weight (out, in); flax Conv
    # kernel (kh, kw, in, out) -> torch conv weight (out, in, kh, kw)
    return v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)


# the DGCNN object backbone and the STGCN human backbone keep the JAX
# modules' names: kernels are reordered, BatchNorm scales renamed
_BACKBONE = (r"(pcd_backbone\.(?:conv\d|linear\d|bn[67])"
             r"|human_backbone\.(?:pos_embed|sk_feat|st_gcn|conv_joint)\w*)")


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
    (_BACKBONE + r"(\..+)?\.kernel", r"\1\2.weight", _kernel),
    (_BACKBONE + r"(\..+)?\.scale", r"\1\2.weight", None),
    # MLPs, attentions, input/output process: the dotted path is the key
    (r"(.+)", r"\1", None),
)
_STAT_RULES = (
    (r"pcd_backbone\.((?:sa|fp)\d)\.mlp_(\d)\.bn\.(mean|var)",
     r"pcd_backbone.\1.mlp_bns.\2.running_\3"),
    (r"pcd_backbone\.head\.bn\.(mean|var)", r"pcd_backbone.bn1.running_\1"),
    (_BACKBONE + r"(\..+)?\.(mean|var)", r"\1\2.running_\3"),
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


# ---------------------------------------------------------------------------
# ContactFormer and its POSA VAE (models/contactformer.py, models/posa.py)

_LSTM_GATES = ("i", "f", "g", "o")  # torch.nn.LSTM's row blocks, in order


def contactformer_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``ContactFormer`` state dict from the JAX module's
    ``params`` tree (numpy arrays; any decoder mode, or a bare ``POSA``'s
    tree).  The names are the JAX modules', so a norm's ``scale`` becomes
    ``weight`` and the rest crosses as it is, but for mode 4's LSTMs:
    flax's ``OptimizedLSTMCell`` keeps one Dense a gate, ``ii``/``if``/
    ``ig``/``io`` with kernel (in, H) and no bias and ``hi``/``hf``/``hg``/
    ``ho`` with kernel (H, H) and a bias; torch stacks the gates' rows as
    (i, f, g, o) and has two biases.  ``lstm_fwd`` becomes the ``_l0``
    direction of the port's bidirectional ``lstm``, ``lstm_bwd`` the
    ``_l0_reverse`` one; the hidden bias is ``bias_hh`` and ``bias_ih`` is
    zero."""
    sd: Dict[str, torch.Tensor] = {}
    cells: Dict[str, Dict[str, np.ndarray]] = {}
    for path, v in _flatten(params).items():
        m = re.fullmatch(r"lstm_(fwd|bwd)\.cell\.(\w\w)\.(kernel|bias)", path)
        if m:
            cells.setdefault(m.group(1), {})[f"{m.group(2)}.{m.group(3)}"] = v
            continue
        sd[re.sub(r"(norm\d?)\.scale$", r"\1.weight", path)] = _f32(v)
    for direction, c in cells.items():
        suffix = "_l0" if direction == "fwd" else "_l0_reverse"
        sd[f"lstm.weight_ih{suffix}"] = _f32(np.concatenate(
            [c[f"i{g}.kernel"].T for g in _LSTM_GATES]))
        sd[f"lstm.weight_hh{suffix}"] = _f32(np.concatenate(
            [c[f"h{g}.kernel"].T for g in _LSTM_GATES]))
        sd[f"lstm.bias_hh{suffix}"] = _f32(np.concatenate(
            [c[f"h{g}.bias"] for g in _LSTM_GATES]))
        sd[f"lstm.bias_ih{suffix}"] = torch.zeros_like(sd[f"lstm.bias_hh{suffix}"])
    return sd


# ---------------------------------------------------------------------------
# the text towers (models/text.py, models/bert.py)

_CLIP_DROPPED = ("visual.", "logit_scale", "text_model.embeddings.position_ids")
# HF CLIPTextModelWithProjection -> OpenAI naming (q/k/v and the
# projection are handled apart)
_CLIP_HF_RULES = (
    (r"text_model\.embeddings\.token_embedding\.weight", "token_embedding.weight"),
    (r"text_model\.embeddings\.position_embedding\.weight", "positional_embedding"),
    (r"text_model\.final_layer_norm\.(weight|bias)", r"ln_final.\1"),
    (r"text_model\.encoder\.layers\.(\d+)\.layer_norm1\.(weight|bias)",
     r"transformer.resblocks.\1.ln_1.\2"),
    (r"text_model\.encoder\.layers\.(\d+)\.layer_norm2\.(weight|bias)",
     r"transformer.resblocks.\1.ln_2.\2"),
    (r"text_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.(weight|bias)",
     r"transformer.resblocks.\1.attn.out_proj.\2"),
    (r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.(weight|bias)",
     r"transformer.resblocks.\1.mlp.c_fc.\2"),
    (r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.(weight|bias)",
     r"transformer.resblocks.\1.mlp.c_proj.\2"),
)
_CLIP_OPENAI = re.compile(
    r"token_embedding\.weight|positional_embedding|text_projection|"
    r"ln_final\.(weight|bias)|transformer\.resblocks\.\d+\.("
    r"ln_[12]\.(weight|bias)|attn\.in_proj_(weight|bias)|"
    r"attn\.out_proj\.(weight|bias)|mlp\.c_(fc|proj)\.(weight|bias))")


def _f32(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32))  # a copy


def clip_text_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``CLIPTextTransformer`` state dict from a torch CLIP text
    tower's, in either naming that the JAX package's
    ``train/checkpoint.py:convert_clip_text`` takes: OpenAI's ``clip``
    (optionally prefixed ``clip_model.``, as inside an SDM checkpoint; the
    port's own naming) or HF ``CLIPTextModelWithProjection`` (q/k/v
    concatenated into ``in_proj``, ``text_projection.weight`` transposed).
    Vision-tower and ``logit_scale`` keys are dropped; any other unknown key
    raises ``KeyError``."""
    sd: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in state_dict.items():
        key = key[len("clip_model."):] if key.startswith("clip_model.") else key
        if key.startswith(_CLIP_DROPPED):
            continue
        v = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        if _CLIP_OPENAI.fullmatch(key):
            sd[key] = _f32(v)
            continue
        if key == "text_projection.weight":
            sd["text_projection"] = _f32(v.T)  # Linear (out, in) -> (width, embed)
            continue
        m = re.fullmatch(r"text_model\.encoder\.layers\.(\d+)\.self_attn\."
                         r"([qkv])_proj\.(weight|bias)", key)
        if m:
            qkv.setdefault(m.group(1), {})[m.group(2) + m.group(3)] = v
            continue
        for pattern, repl in _CLIP_HF_RULES:
            if re.fullmatch(pattern, key):
                sd[re.sub(pattern, repl, key)] = _f32(v)
                break
        else:
            raise KeyError(f"unmapped CLIP parameter: {key} {v.shape}")
    for layer, d in qkv.items():
        for kind in ("weight", "bias"):
            sd[f"transformer.resblocks.{layer}.attn.in_proj_{kind}"] = _f32(
                np.concatenate([d["q" + kind], d["k" + kind], d["v" + kind]], 0))
    return sd


def clip_text_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``CLIPTextTransformer`` state dict from the JAX tower's
    ``params`` tree (numpy arrays): the same tensors, renamed."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        key = re.sub(r"^resblock_(\d+)\.", r"transformer.resblocks.\1.", path)
        key = re.sub(r"\.mlp_(c_fc|c_proj)\.", r".mlp.\1.", key)
        key = re.sub(r"(ln_1|ln_2|ln_final)\.scale$", r"\1.weight", key)
        if key == "token_embedding":
            key = "token_embedding.weight"
        sd[key] = _f32(v)
    return sd


def bert_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``BertModel`` state dict from an HF torch BERT checkpoint
    (``BertModel``, or ``BertFor*`` with the ``bert.`` prefix; LayerNorm
    ``gamma``/``beta`` as older checkpoints name them).  Heads (``cls.``)
    and the ``position_ids`` buffer are dropped."""
    sd: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        key = key[len("bert."):] if key.startswith("bert.") else key
        if key.startswith("cls.") or key.endswith("position_ids"):
            continue
        key = re.sub(r"LayerNorm\.gamma$", "LayerNorm.weight", key)
        key = re.sub(r"LayerNorm\.beta$", "LayerNorm.bias", key)
        sd[key] = torch.as_tensor(val).float().contiguous()
    return sd


def bert_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``BertModel`` state dict from ``FlaxBertModel``'s params
    (numpy arrays): embedding tables as they are, Dense kernels (in, out)
    transposed, LayerNorm ``scale`` as ``weight``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        if path.endswith(".kernel"):
            sd[path[:-len("kernel")] + "weight"] = _f32(np.asarray(v).T)
        elif path.endswith((".embedding", ".scale")):
            sd[path.rsplit(".", 1)[0] + ".weight"] = _f32(v)
        else:
            sd[path] = _f32(v)
    return sd


# ---------------------------------------------------------------------------
# ATISS and MIME (models/atiss.py, models/feature_extractors.py)

_FE = "feature_extractor._feature_extractor"
# (pattern on the dotted JAX path, replacement, value transform or None);
# the first that matches applies
_ATISS_RULES = (
    (r"layer_(\d+)\.in_proj_(weight|bias)",
     r"transformer_encoder.layers.\1.self_attn.in_proj_\2", None),
    (r"layer_(\d+)\.attn_out_proj\.(weight|bias)",
     r"transformer_encoder.layers.\1.self_attn.out_proj.\2", None),
    (r"layer_(\d+)\.(norm[12])\.scale", r"transformer_encoder.layers.\1.\2.weight", None),
    (r"layer_(\d+)\.(.+)", r"transformer_encoder.layers.\1.\2", None),
    # the simple extractor: flax Conv / Dense kernels
    (r"feature_extractor\.(conv\d|fc)\.kernel", r"feature_extractor.\1.weight", _kernel),
    (r"feature_extractor\.(conv\d)\.bias", r"feature_extractor.\1.bias", None),
    # ResNet18 (names layerN_M, downsample_0/1, fc_0/2) and AlexNet
    (r"feature_extractor\.(layer\d)_(\d)\.downsample_(\d)\.scale",
     _FE + r".\1.\2.downsample.\3.weight", None),
    (r"feature_extractor\.(layer\d)_(\d)\.downsample_(\d)\.(.+)",
     _FE + r".\1.\2.downsample.\3.\4", None),
    (r"feature_extractor\.(layer\d)_(\d)\.(bn\d)\.scale", _FE + r".\1.\2.\3.weight", None),
    (r"feature_extractor\.(layer\d)_(\d)\.(.+)", _FE + r".\1.\2.\3", None),
    (r"feature_extractor\.bn1\.scale", _FE + ".bn1.weight", None),
    (r"feature_extractor\.(conv1|bn1)\.(.+)", _FE + r".\1.\2", None),
    (r"feature_extractor\.fc_(\d)\.(.+)", _FE + r".fc.\1.\2", None),
    (r"feature_extractor\.features_(\d+)\.(.+)", _FE + r".features.\1.\2", None),
    # tokens, projections and the property head: the dotted path is the key
    (r"(.+)", r"\1", None),
)


def _jax_to_port(path: str, rules) -> str:
    for pattern, repl, fn in rules:
        if re.fullmatch(pattern, path):
            return re.sub(pattern, repl, path), fn
    raise KeyError(f"unmapped JAX parameter: {path}")


def atiss_state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                              dtype: torch.dtype = torch.float32
                              ) -> Dict[str, torch.Tensor]:
    """The port's ATISS / MIME / PE state dict (reference torch names, the
    simple extractor's own) from a JAX ``AutoregressiveTransformer``'s
    ``variables["params"]`` and ``variables["batch_stats"]`` (numpy
    arrays): flax Conv / Dense kernels of the simple extractor reordered,
    norms' ``scale`` renamed ``weight``, the ResNet's ``mean`` / ``var``
    statistics renamed ``running_mean`` / ``running_var``; the rest
    crosses as it is (JAX keeps torch's layouts).  The inverse of
    ``lsdm_tpu/train/checkpoint.py:convert_atiss_state_dict`` where that
    covers the model (not the simple extractor).  ``dtype``: the tensors'
    (float64 keeps a float64 tree's values, or its gradients)."""

    def tensor(v):
        return torch.tensor(np.asarray(v), dtype=dtype)  # a copy

    sd: Dict[str, torch.Tensor] = {}
    flat = _flatten(params)
    alexnet = "feature_extractor.fc.weight" in flat  # the simple one's is a kernel
    for path, v in flat.items():
        if alexnet and path.startswith("feature_extractor.fc."):
            path = "feature_extractor._fc." + path.rsplit(".", 1)[1]
        key, fn = _jax_to_port(path, _ATISS_RULES)
        sd[key] = tensor(v if fn is None else fn(v))
    for path, v in _flatten(batch_stats or {}).items():
        key, _ = _jax_to_port(path, _ATISS_RULES)
        sd[re.sub(r"\.(mean|var)$", r".running_\1", key)] = tensor(v)
    return sd


# reference keys the port's ATISS has no place for, dropped as the JAX
# converter drops them: the unused start token, AlexNet's pooling and
# classifier, BatchNorm's step counter
_ATISS_DROPPED = re.compile(r"start_token_embedding|" + re.escape(_FE)
                            + r"\.(avgpool|classifier)\..*|.*\.num_batches_tracked")


def atiss_state_dict(state_dict: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """A reference ATISS / MIME state dict (or the port's own) made ready
    for ``model.load_state_dict(..., strict=True)``: the keys the JAX
    converter drops are dropped, and a key ``model`` has no place for
    raises ``KeyError``, as that converter raises."""
    own = model.state_dict()
    out = {}
    for key, v in state_dict.items():
        if _ATISS_DROPPED.fullmatch(key):
            continue
        if key not in own:
            raise KeyError(f"unmapped ATISS parameter: {key} {tuple(v.shape)}")
        out[key] = v
    return out
