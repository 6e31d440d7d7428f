"""ATISS and MIME: the autoregressive scene transformers, their property
heads, their losses and their scene-generation API.

Counterpart of ``lsdm_tpu/models/atiss.py`` (reference
``atiss/scene_synthesis/networks/``).  ContactFormer stacks
:class:`TorchTransformerEncoderLayer`, which keeps the JAX layer's
parameter names.  The scene transformers take the reference torch
state_dict's names instead (``transformer_encoder.layers.0.self_attn.
in_proj_weight``, ``hidden2output.centroid_layer_x.0.weight``,
``feature_extractor._feature_extractor.layer1.0.bn1.running_var``), so a
reference ``.pt`` loads with ``load_state_dict`` (``checkpoint.py:
load_atiss_checkpoint``) and JAX's ``convert_atiss_state_dict`` reads the
port's own; the "simple" extractor, which has no reference, keeps flax's
module names (``feature_extractor.conv0``).

Where a plain port would part from the JAX package:

  * ``torch_seq_axis_quirk``: the encoder attends over the BATCH axis, as
    the reference did by feeding batch-first tensors to a
    ``batch_first=False`` encoder; ``valid_mask`` is ignored there, and at
    B = 1 each token attends only to itself;
  * ``valid_mask``: padded slots are an additive -1e9 key bias, the start
    and empty tokens always valid, tiled over the heads as ``jnp.tile``
    tiles it (head-major) and read batch-major by the attention, as JAX
    reads it: at B > 1 the bias of head h of scene b is scene
    ``(b * H + h) mod B``'s;
  * the simple extractor's 3x3 stride-2 convolutions pad as flax's "SAME"
    (0 before, 1 after on a 64-wide map), not ``padding=1``;
  * the property head casts its targets to float32 (``.astype``) before
    it encodes them, also in a float64 model;
  * the JAX layers' dropout runs only under ``train=True``, which no JAX
    entry point passes: there is none here.

Random draws: ``jax.random.categorical`` is the argmax of the logits plus
Gumbel noise, the DMLL sampler a uniform in [1e-5, 1 - 1e-5].  The
samplers take them from a :class:`Draws`, which draws from a
``torch.Generator`` or replays given tensors (the parity tests pass
JAX's), in the order they are asked for.  The autoregressive fill is a
Python loop over fixed (B, L, .) buffers, one ``decode_step`` a box; its
stop test reads batch element 0 after the box is written, as JAX's
``lax.while_loop`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.models.cudnn import cudnn_full_fp32
from lsdm_tpu_torch.models.feature_extractors import (
    AlexNetFeatures, ResNet18Features, to_nchw)
from lsdm_tpu_torch.ops.attention import Linear, multihead_attention

Boxes = Dict[str, torch.Tensor]


def fixed_positional_encoding(x: torch.Tensor, proj_dims: int = 64,
                              val: float = 0.1) -> torch.Tensor:
    """sin/cos at fixed frequencies (reference ``base.py:13-26``):
    (..., 1) -> (..., proj_dims), in ``x``'s dtype."""
    ll = proj_dims // 2
    exb = 2 * torch.linspace(0, ll - 1, ll, dtype=x.dtype, device=x.device) / proj_dims
    sigma = 2 * math.pi / torch.pow(torch.tensor(val, dtype=x.dtype,
                                                 device=x.device), exb)
    return torch.cat([torch.sin(x * sigma), torch.cos(x * sigma)], dim=-1)


class TorchTransformerEncoderLayer(nn.Module):
    """``torch.nn.TransformerEncoderLayer`` parity (post-LN, exact GELU),
    with the JAX module's parameter names (``in_proj_weight``,
    ``attn_out_proj``, ``linear1``/``linear2``, ``norm1``/``norm2``).
    No dropout (module docstring)."""

    def __init__(self, d_model: int, n_heads: int, dim_ff: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.attn_out_proj = Linear(d_model, d_model)
        self.linear1 = Linear(d_model, dim_ff)
        self.linear2 = Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        # attn_bias: additive (L, S) or (B*H, L, S) mask (key padding etc.)
        attn = _self_attention(x, self.in_proj_weight, self.in_proj_bias,
                               self.n_heads, attn_bias)
        x = self.norm1(x + self.attn_out_proj(attn))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


def _self_attention(x, in_w, in_b, n_heads, attn_bias):
    q, k, v = F.linear(x, in_w, in_b).chunk(3, -1)
    return multihead_attention(q, k, v, n_heads, attn_mask=attn_bias,
                               need_weights=False)[0]


class MultiheadSelfAttention(nn.Module):
    """Self-attention with ``torch.nn.MultiheadAttention``'s names
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.out_proj(_self_attention(
            x, self.in_proj_weight, self.in_proj_bias, self.n_heads, attn_bias))


class TransformerEncoderLayer(nn.Module):
    """The same layer with ``torch.nn.TransformerEncoderLayer``'s names
    (``self_attn``, ``linear1``/``linear2``, ``norm1``/``norm2``), as the
    reference ATISS checkpoints hold them."""

    def __init__(self, d_model: int, n_heads: int, dim_ff: int):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, attn_bias))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class _Encoder(nn.Module):
    def __init__(self, n_layers: int, d_model: int, n_heads: int, dim_ff: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(d_model, n_heads, dim_ff)
                                    for _ in range(n_layers))


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's "SAME" padding of a k x k, stride-s convolution: the
    shortfall split with the smaller half before."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad's order: W, then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class RoomFeatureExtractor(nn.Module):
    """The "simple" extractor: four 3x3 stride-2 convolutions (16, 32, 64,
    128 channels, ReLU) with flax's SAME padding, a spatial mean and a
    Linear to ``feature_size``.  Names: ``conv0``..``conv3``, ``fc``."""

    def __init__(self, feature_size: int = 64, input_channels: int = 1):
        super().__init__()
        cin = input_channels
        for i, feats in enumerate((16, 32, 64, 128)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, feats, 3, 2))
            cin = feats
        self.fc = nn.Linear(128, feature_size)

    def forward(self, room_mask: torch.Tensor) -> torch.Tensor:
        x = to_nchw(room_mask)
        with cudnn_full_fp32():
            for i in range(4):
                x = F.relu(getattr(self, f"conv{i}")(_same_pad(x, 3, 2)))
        return self.fc(x.mean(dim=(2, 3)))


class BBoxPrediction(NamedTuple):
    """Prediction container (reference ``AutoregressiveBBoxOutput.members``
    order, ``bbox_output.py:70-80``)."""

    sizes_x: torch.Tensor
    sizes_y: torch.Tensor
    sizes_z: torch.Tensor
    translations_x: torch.Tensor
    translations_y: torch.Tensor
    translations_z: torch.Tensor
    angles: torch.Tensor
    class_labels: torch.Tensor

    @property
    def members(self):
        return tuple(self)


class Draws:
    """The random draws of the samplers, in the order they are asked for:
    Gumbel noise for a categorical (``jax.random.gumbel``:
    ``-log(-log(U))``, U uniform in [tiny, 1)) and uniforms in [low, high).
    From ``generator`` (torch's default generator when None; it must sit
    on the device asked for), or replayed from ``given`` (the tests pass
    JAX's draws), checked shape for shape.  ``record=True`` keeps what was
    drawn in ``taken``, to replay it elsewhere."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 given: Optional[Iterable] = None, record: bool = False):
        self.generator = generator
        self._given = None if given is None else iter(given)
        self.taken = [] if record else None

    def _next(self, shape, like: torch.Tensor, draw) -> torch.Tensor:
        if self._given is not None:
            t = torch.as_tensor(next(self._given), dtype=like.dtype,
                                device=like.device)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"a given draw of shape {tuple(t.shape)} where "
                                 f"{tuple(shape)} is asked for")
        else:
            t = draw(torch.rand(shape, generator=self.generator, dtype=like.dtype,
                                device=like.device))
        if self.taken is not None:
            self.taken.append(t.detach().cpu())
        return t

    def gumbel(self, shape, like: torch.Tensor) -> torch.Tensor:
        tiny = torch.finfo(like.dtype).tiny
        return self._next(shape, like,
                          lambda u: -torch.log(-torch.log(u.clamp_min(tiny))))

    def uniform(self, shape, like: torch.Tensor, low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        return self._next(shape, like,
                          lambda u: (u * (high - low) + low).clamp_min(low))


DrawSource = Union[Draws, torch.Generator, None]


def as_draws(d: DrawSource) -> Draws:
    """``d`` as a :class:`Draws` (a generator, or None, drawn from)."""
    return d if isinstance(d, Draws) else Draws(d)


class _PropertyMLP(nn.Sequential):
    """Property head (reference ``AutoregressiveDMLL._mlp``):
    Linear(h, 2h), ReLU, Linear(2h, h), ReLU, Linear(h, out), and with
    ``scalar`` (the LSDM fork) ReLU, Linear(out, 1)."""

    def __init__(self, h: int, out_size: int, scalar: bool = True):
        layers = [nn.Linear(h, 2 * h), nn.ReLU(), nn.Linear(2 * h, h), nn.ReLU(),
                  nn.Linear(h, out_size)]
        if scalar:
            layers += [nn.ReLU(), nn.Linear(out_size, 1)]
        super().__init__(*layers)


class _ExtraFC(nn.Sequential):
    """Optional pre-head MLP (reference ``hidden_to_output.py:23-29``),
    applied only in the training forward, as the reference does."""

    def __init__(self, h: int):
        super().__init__(nn.Linear(h, 2 * h), nn.ReLU(), nn.Linear(2 * h, h),
                         nn.ReLU())


def _targets(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    # JAX's .astype(jnp.float32), then the model's dtype
    return t.float().to(like.dtype)


class AutoregressiveDMLLHead(nn.Module):
    """(reference ``AutoregressiveDMLL``, ``hidden_to_output.py:53-306``):
    class logits, then translation, angle and size, each conditioned on
    the previous properties' (target or sampled) values."""

    def __init__(self, n_classes: int, n_mixtures: int = 10,
                 scalar_head: bool = True, hidden_size: int = 512,
                 with_extra_fc: bool = False):
        super().__init__()
        self.scalar_head = scalar_head
        H = hidden_size
        out = n_mixtures * 3
        self.class_layer = nn.Linear(H, n_classes)
        self.fc_class_labels = nn.Linear(n_classes, 64)
        for name, width in (("centroid_layer", H + 64), ("size_layer", H + 320)):
            for ax in "xyz":
                setattr(self, f"{name}_{ax}", _PropertyMLP(width, out, scalar_head))
        self.angle_layer = _PropertyMLP(H + 256, out, scalar_head)
        if with_extra_fc:
            self.hidden2output = _ExtraFC(H)

    def _chain_features(self, x, class_labels, translations=None, angles=None):
        # given values in x's dtype, as flax's Linear casts its input
        cf = torch.cat([x, self.fc_class_labels(class_labels.to(x.dtype))], dim=-1)
        if translations is None:
            return cf
        tr = translations.to(x.dtype)
        tf = torch.cat([cf] + [fixed_positional_encoding(tr[..., i:i + 1])
                               for i in range(3)], dim=-1)
        if angles is None:
            return tf
        return torch.cat([tf, fixed_positional_encoding(angles.to(x.dtype))], dim=-1)

    def forward(self, x: torch.Tensor, targets: Boxes) -> BBoxPrediction:
        """Training path (reference ``hidden_to_output.py:266-306``): each
        property conditioned on the TARGET values of the previous."""
        if hasattr(self, "hidden2output"):
            x = self.hidden2output(x)
        cls = _targets(targets["class_labels_tr"], x)
        tr = _targets(targets["translations_tr"], x)
        ang = _targets(targets["angles_tr"], x)
        cf = self._chain_features(x, cls)
        t = [getattr(self, f"centroid_layer_{ax}")(cf) for ax in "xyz"]
        angles = self.angle_layer(self._chain_features(x, cls, tr))
        sf = self._chain_features(x, cls, tr, ang)
        s = [getattr(self, f"size_layer_{ax}")(sf) for ax in "xyz"]
        return BBoxPrediction(*s, *t, angles, self.class_layer(x))

    # --- sampling path (reference :166-226)

    def pred_class_probs(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.class_layer(x), dim=-1)

    def sample_class_labels(self, x: torch.Tensor, draws: DrawSource = None
                            ) -> torch.Tensor:
        logits = self.class_layer(x)
        B, L, C = logits.shape
        flat = logits.reshape(B * L, C)
        idx = torch.argmax(flat + as_draws(draws).gumbel(flat.shape, flat), dim=-1)
        return F.one_hot(idx, C).to(x.dtype).reshape(B, L, C)

    def _sample_value(self, pred: torch.Tensor, draws: Draws) -> torch.Tensor:
        if self.scalar_head:
            return pred
        B, L, C = pred.shape
        return sample_from_dmll(pred.reshape(B * L, C), draws).reshape(B, L, 1)

    def sample_translations(self, x, class_labels, draws: DrawSource = None):
        cf = self._chain_features(x, class_labels)
        d = as_draws(draws)
        return torch.cat([self._sample_value(getattr(self, f"centroid_layer_{ax}")(cf), d)
                          for ax in "xyz"], dim=-1)

    def sample_angles(self, x, class_labels, translations, draws: DrawSource = None):
        tf = self._chain_features(x, class_labels, translations)
        return self._sample_value(self.angle_layer(tf), as_draws(draws))

    def sample_sizes(self, x, class_labels, translations, angles,
                     draws: DrawSource = None):
        sf = self._chain_features(x, class_labels, translations, angles)
        d = as_draws(draws)
        return torch.cat([self._sample_value(getattr(self, f"size_layer_{ax}")(sf), d)
                          for ax in "xyz"], dim=-1)

    def pred_dmll_params_translation(self, x, class_labels):
        """(reference ``hidden_to_output.py:240-264``; meaningful with
        ``scalar_head=False``): per axis (probs, means, scales), each
        (B*L, n_mixtures)."""
        cf = self._chain_features(x, class_labels)

        def unpack(pred):
            p = pred.reshape(-1, pred.shape[-1])
            nr = p.shape[-1] // 3
            return (torch.softmax(p[:, :nr], dim=-1), p[:, nr:2 * nr],
                    F.elu(p[:, 2 * nr:]) + 1.0001)

        return tuple(unpack(getattr(self, f"centroid_layer_{ax}")(cf)) for ax in "xyz")


def sample_from_dmll(pred: torch.Tensor, draws: DrawSource = None,
                     num_classes: int = 256) -> torch.Tensor:
    """Sample a mixture of logistics (reference ``base.py:27-51``):
    pred (N, 3*nr_mix) -> (N, 1) clipped to [-1, 1].  Draws: Gumbel noise
    (N, nr_mix) for the component, then a uniform (N,) in [1e-5, 1-1e-5)."""
    d = as_draws(draws)
    N, C = pred.shape
    nr = C // 3
    logits = pred[:, :nr]
    idx = torch.argmax(logits + d.gumbel(logits.shape, logits), dim=-1)[:, None]
    means = torch.gather(pred[:, nr:2 * nr], 1, idx)[:, 0]
    scales = F.elu(torch.gather(pred[:, 2 * nr:], 1, idx)[:, 0]) + 1.0001
    u = d.uniform((N,), pred, 1e-5, 1 - 1e-5)
    out = means + scales * (torch.log(u) - torch.log(1 - u))
    return torch.clamp(out, -1, 1)[:, None]


def dmll(pred: torch.Tensor, target: torch.Tensor, log_scale_min: float = -7.0,
         num_classes: int = 256) -> torch.Tensor:
    """Discretized mixture-of-logistics NLL (reference
    ``losses/__init__.py:39-``): pred (B, L, 3*nr_mix), target (B, L, 1)
    in [-1, 1] -> scalar mean NLL."""
    nr = pred.shape[-1] // 3
    logit_probs = pred[..., :nr]
    means = pred[..., nr:2 * nr]
    log_scales = torch.clamp(pred[..., 2 * nr:], min=log_scale_min)
    centered = target - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - math.log((num_classes - 1) / 2))
    log_probs = torch.where(target < -0.999, log_cdf_plus,
                            torch.where(target > 0.999, log_one_minus_cdf_min, inner))
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    return -torch.mean(torch.logsumexp(log_probs, dim=-1))


def mmd(x: torch.Tensor, y: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Gaussian-kernel maximum mean discrepancy (reference
    ``losses/mmd.py:46``)."""

    def k(a, b):
        d = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
        return torch.exp(-d / (2 * sigma ** 2))

    return torch.mean(k(x, x)) + torch.mean(k(y, y)) - 2 * torch.mean(k(x, y))


class AutoregressiveTransformer(nn.Module):
    """(reference ``AutoregressiveTransformer``,
    ``autoregressive_transformer.py:97-227``).  Tokens: a room-layout start
    token, a learned empty token, then one token a box (class 64, position
    and size 3 x 64 each, angle 64 = 512; MIME adds a 16-wide contact
    channel, 528), mapped by ``fc`` to the encoder's ``hidden_dims``; the
    encoder's output at the empty token feeds the property head."""

    def __init__(self, n_classes: int, n_layers: int = 4, n_heads: int = 8,
                 dim_ff: int = 1024, hidden_dims: int = 512, n_mixtures: int = 10,
                 scalar_head: bool = True, feature_size: int = 64,
                 contact: bool = False, feature_extractor_name: str = "simple",
                 freeze_bn: bool = True, torch_seq_axis_quirk: bool = False,
                 prop_pe_dims: int = 64, class_feat_dims: int = 64):
        super().__init__()
        self.n_classes = n_classes
        self.n_heads = n_heads
        self.contact = contact
        self.torch_seq_axis_quirk = torch_seq_axis_quirk
        self.prop_pe_dims = prop_pe_dims
        self.feature_extractor_name = feature_extractor_name
        self.freeze_bn = freeze_bn
        D = self.d_model
        if feature_extractor_name == "resnet18":
            self.feature_extractor = ResNet18Features(feature_size, freeze_bn)
        elif feature_extractor_name == "alexnet":
            self.feature_extractor = AlexNetFeatures(feature_size)
        elif feature_extractor_name == "simple":
            self.feature_extractor = RoomFeatureExtractor(feature_size)
        else:
            raise ValueError(f"feature extractor {feature_extractor_name!r}: "
                             "'simple', 'resnet18' or 'alexnet'")
        self.fc_room_f = nn.Linear(feature_size, D)
        self.fc_class = nn.Linear(n_classes, class_feat_dims, bias=False)
        if contact:
            self.contact_fc = nn.Linear(1, 16, bias=False)
        self.empty_token_embedding = nn.Parameter(torch.randn(1, D))
        self.transformer_encoder = _Encoder(n_layers, hidden_dims, n_heads, dim_ff)
        self.fc = nn.Linear(D, hidden_dims)
        self.hidden2output = AutoregressiveDMLLHead(
            n_classes, n_mixtures, scalar_head, hidden_dims)

    @property
    def d_model(self) -> int:
        return 528 if self.contact else 512

    def _box_tokens(self, boxes: Boxes) -> torch.Tensor:
        dt = self.fc_class.weight.dtype
        P = self.prop_pe_dims
        tr, sz = boxes["translations"].to(dt), boxes["sizes"].to(dt)
        feats = [self.fc_class(boxes["class_labels"].to(dt))]
        feats += [fixed_positional_encoding(tr[..., i:i + 1], P) for i in range(3)]
        feats += [fixed_positional_encoding(sz[..., i:i + 1], P) for i in range(3)]
        feats.append(fixed_positional_encoding(boxes["angles"].to(dt), P))
        if self.contact:
            feats.insert(0, self.contact_fc(boxes["contact_labels"].to(dt)))
        return torch.cat(feats, dim=-1)  # (B, L, d_model)

    def encode(self, boxes: Boxes) -> torch.Tensor:
        """Token sequence -> the feature at the empty token, (B, 1, hidden)
        (reference ``forward`` / ``_encode``).  ``boxes["valid_mask"]``
        (B, L), optional: padded slots leave attention by a key bias
        (module docstring)."""
        room = boxes["room_layout"].to(self.fc_room_f.weight.dtype)
        room_f = self.fc_room_f(self.feature_extractor(room))
        X = self._box_tokens(boxes)
        B, L = X.shape[:2]
        empty = self.empty_token_embedding[None].expand(B, 1, self.d_model)
        X = self.fc(torch.cat([room_f[:, None], empty, X], dim=1))
        layers = self.transformer_encoder.layers
        if self.torch_seq_axis_quirk:
            X = X.transpose(0, 1)  # "sequence" = scenes, as torch saw it
            for layer in layers:
                X = layer(X)
            return X.transpose(0, 1)[:, 1:2]
        bias = None
        if boxes.get("valid_mask") is not None:
            valid = torch.cat([torch.ones(B, 2, dtype=X.dtype, device=X.device),
                               boxes["valid_mask"].to(X.dtype)], dim=1)
            bias = torch.where(valid > 0, 0.0, -1e9).to(X.dtype)[:, None, :]
            bias = bias.expand(B, L + 2, L + 2).repeat(self.n_heads, 1, 1)
        for layer in layers:
            X = layer(X, bias)
        return X[:, 1:2]

    def forward(self, sample_params: Boxes) -> BBoxPrediction:
        return self.hidden2output(self.encode(sample_params), sample_params)

    # --- generation (reference autoregressive_decode / generate_boxes)

    def decode_step(self, boxes: Boxes, draws: DrawSource = None) -> Boxes:
        F_ = self.encode(boxes)
        d, h = as_draws(draws), self.hidden2output
        cls = h.sample_class_labels(F_, d)
        tr = h.sample_translations(F_, cls, d)
        ang = h.sample_angles(F_, cls, tr, d)
        sz = h.sample_sizes(F_, cls, tr, ang, d)
        return {"class_labels": cls, "translations": tr, "sizes": sz, "angles": ang}

    def decode_step_with_class(self, boxes: Boxes, class_label: torch.Tensor,
                               draws: DrawSource = None) -> Boxes:
        """Translation, angle and size for a GIVEN class (reference
        ``autoregressive_decode_with_class_label``, :229-259)."""
        F_ = self.encode(boxes)
        d, h = as_draws(draws), self.hidden2output
        tr = h.sample_translations(F_, class_label, d)
        ang = h.sample_angles(F_, class_label, tr, d)
        sz = h.sample_sizes(F_, class_label, tr, ang, d)
        return {"class_labels": class_label, "translations": tr, "sizes": sz,
                "angles": ang}

    def decode_step_with_class_and_translation(
            self, boxes: Boxes, class_label: torch.Tensor,
            translation: torch.Tensor, draws: DrawSource = None) -> Boxes:
        """(reference ``autoregressive_decode_with_class_label_and_
        translation``, :336-366)"""
        F_ = self.encode(boxes)
        d, h = as_draws(draws), self.hidden2output
        ang = h.sample_angles(F_, class_label, translation, d)
        sz = h.sample_sizes(F_, class_label, translation, ang, d)
        return {"class_labels": class_label, "translations": translation,
                "sizes": sz, "angles": ang}

    def distribution_classes(self, boxes: Boxes) -> torch.Tensor:
        """Class distribution of the next object (``scene_completion``)."""
        return self.hidden2output.pred_class_probs(self.encode(boxes))

    def distribution_translations(self, boxes: Boxes, class_label: torch.Tensor):
        """DMLL parameters of the translations for a given class (reference
        ``distribution_translations``, :433-468)."""
        return self.hidden2output.pred_dmll_params_translation(
            self.encode(boxes), class_label)


class AutoregressiveTransformerPE(AutoregressiveTransformer):
    """Learned-slot-position ATISS variant (reference
    ``AutoregressiveTransformerPE``, :470-584), as the JAX package repairs
    it: 60-wide property encodings and class projection, and a learned
    32-wide embedding of each box slot (``positional_embedding``, at most
    32 slots), 60 + 180 + 180 + 60 + 32 = 512."""

    def __init__(self, n_classes: int, prop_pe_dims: int = 60,
                 class_feat_dims: int = 60, slot_pe_dims: int = 32,
                 max_seq_length: int = 32, **kw):
        if kw.get("contact"):
            raise ValueError("the PE variant is ATISS-only upstream")
        super().__init__(n_classes, prop_pe_dims=prop_pe_dims,
                         class_feat_dims=class_feat_dims, **kw)
        self.positional_embedding = nn.Parameter(
            torch.randn(max_seq_length, slot_pe_dims))

    def _box_tokens(self, boxes: Boxes) -> torch.Tensor:
        X = super()._box_tokens(boxes)
        B, L = X.shape[:2]
        n = self.positional_embedding.shape[0]
        if L > n:
            raise ValueError(f"{L} box slots > max_seq_length={n}")
        pe = self.positional_embedding[None, :L].to(X.dtype)
        return torch.cat([X, pe.expand(B, L, -1)], dim=-1)


def MIME(n_classes: int, **kw) -> AutoregressiveTransformer:
    """MIME = ATISS + contact channel (reference ``mime.py``); the encoder
    is 528 wide (``mime.py:19-23``), 8 heads of 66."""
    kw.setdefault("hidden_dims", 528)
    return AutoregressiveTransformer(n_classes, contact=True, **kw)


# ---------------------------------------------------------------------------
# Scene generation (reference ``autoregressive_transformer.py:209-468``).
# ``boxes`` never holds the reference's start symbol: ``encode`` prepends
# the room-feature start token and the empty token itself.

_BOX_KEYS = ("class_labels", "translations", "sizes", "angles")


def _zero_boxes(B: int, L: int, C: int, dtype, device) -> Boxes:
    return {k: torch.zeros(B, L, w, dtype=dtype, device=device)
            for k, w in zip(_BOX_KEYS, (C, 3, 3, 1))}


def end_symbol(n_classes: int, dtype=torch.float32, device=None) -> Boxes:
    """(reference ``end_symbol``, :72-80)"""
    d = _zero_boxes(1, 1, n_classes, dtype, device)
    d["class_labels"][0, 0, -1] = 1.0
    return d


def _empty_boxes(B: int, L: int, C: int, contact: bool, dtype=torch.float32,
                 device=None) -> Boxes:
    d = _zero_boxes(B, L, C, dtype, device)
    d["valid_mask"] = torch.zeros(B, L, dtype=dtype, device=device)
    if contact:
        d["contact_labels"] = torch.zeros(B, L, 1, dtype=dtype, device=device)
    return d


def _as_class_onehot(class_label, n_classes: int, device=None) -> torch.Tensor:
    """int | (C,) | (1, 1, C) -> a (1, 1, C) float32 one-hot (reference
    :265-274)."""
    t = torch.as_tensor(class_label, device=device)
    if t.dim() == 0:
        return F.one_hot(t.long(), n_classes).float()[None, None]
    return t.float().reshape(1, 1, n_classes)


@torch.no_grad()
def _autoregressive_fill(model: AutoregressiveTransformer, boxes: Boxes,
                         draws: DrawSource, start: int, limit: int
                         ) -> Tuple[Boxes, int]:
    """Shared loop of generate_boxes / complete_scene: decode into slots
    [start, limit) until the end symbol is sampled (the end box is written
    before the loop stops; the test reads batch element 0)."""
    d = as_draws(draws)
    i = start
    while i < limit:
        box = model.decode_step(boxes, d)
        for name in _BOX_KEYS:
            boxes[name][:, i:i + 1] = box[name].to(boxes[name].dtype)
        boxes["valid_mask"][:, i] = 1.0
        i += 1
        if bool(box["class_labels"][0, 0, -1] == 1):
            break
    return boxes, i


def generate_boxes(model: AutoregressiveTransformer, room_mask: torch.Tensor,
                   draws: DrawSource = None, max_boxes: int = 32
                   ) -> Tuple[Boxes, int]:
    """Generate a whole scene (reference ``generate_boxes``, :209-227).
    Returns (boxes, count): (B, max_boxes, .) buffers whose first ``count``
    slots are generated (the last the end symbol unless ``max_boxes`` ran
    out), and their ``valid_mask``."""
    boxes = _empty_boxes(room_mask.shape[0], max_boxes, model.n_classes,
                         model.contact, device=room_mask.device)
    boxes["room_layout"] = room_mask
    return _autoregressive_fill(model, boxes, draws, 0, max_boxes)


def complete_scene(model: AutoregressiveTransformer, boxes: Boxes,
                   room_mask: torch.Tensor, draws: DrawSource = None,
                   max_boxes: int = 100) -> Tuple[Boxes, int]:
    """Autocomplete a partial scene (reference ``complete_scene``,
    :303-334): keeps the given boxes and appends up to ``max_boxes``."""
    B, L0, C = boxes["class_labels"].shape
    dev = room_mask.device
    out = _empty_boxes(B, L0 + max_boxes, C, model.contact, device=dev)
    for name in _BOX_KEYS + ("contact_labels",):
        if name in boxes:
            out[name][:, :L0] = boxes[name].float().to(dev)
    given = boxes.get("valid_mask")
    out["valid_mask"][:, :L0] = 1.0 if given is None else given.float().to(dev)
    out["room_layout"] = room_mask
    return _autoregressive_fill(model, out, draws, L0, L0 + max_boxes)


@torch.no_grad()
def add_object(model: AutoregressiveTransformer, room_mask: torch.Tensor,
               class_label, boxes: Boxes, draws: DrawSource = None) -> Boxes:
    """Place one object of a requested class (reference ``add_object``,
    :261-301): the boxes with the sampled object and the end symbol
    appended."""
    cls = _as_class_onehot(class_label, model.n_classes, room_mask.device)
    box = model.decode_step_with_class(dict(boxes, room_layout=room_mask), cls, draws)
    return _append_with_end(model, boxes, box)


@torch.no_grad()
def add_object_with_class_and_translation(
        model: AutoregressiveTransformer, room_mask: torch.Tensor, class_label,
        translation, boxes: Boxes, draws: DrawSource = None) -> Boxes:
    """(reference ``add_object_with_class_and_translation``, :368-417)"""
    dev = room_mask.device
    cls = _as_class_onehot(class_label, model.n_classes, dev)
    tr = torch.as_tensor(translation, dtype=torch.float32, device=dev).reshape(1, 1, 3)
    box = model.decode_step_with_class_and_translation(
        dict(boxes, room_layout=room_mask), cls, tr, draws)
    return _append_with_end(model, boxes, box)


def _append_with_end(model, boxes: Boxes, box: Boxes) -> Boxes:
    end = end_symbol(model.n_classes, box["sizes"].dtype, box["sizes"].device)
    out = {}
    for k in _BOX_KEYS:
        dt = torch.promote_types(boxes[k].dtype, box[k].dtype)
        out[k] = torch.cat([boxes[k].to(dt), box[k].to(dt), end[k].to(dt)], dim=1)
    return out


@torch.no_grad()
def distribution_translations(model: AutoregressiveTransformer, boxes: Boxes,
                              room_mask: torch.Tensor, class_label):
    """(reference ``distribution_translations``, :433-468)"""
    cls = _as_class_onehot(class_label, model.n_classes, room_mask.device)
    return model.distribution_translations(dict(boxes, room_layout=room_mask), cls)


def model_flags(model: AutoregressiveTransformer) -> Dict[str, object]:
    """The graph flags a checkpoint of ``model`` must be read back with."""
    return {"feature_extractor": model.feature_extractor_name,
            "freeze_bn": model.freeze_bn,
            "torch_seq_axis_quirk": model.torch_seq_axis_quirk,
            "pe": isinstance(model, AutoregressiveTransformerPE)}

