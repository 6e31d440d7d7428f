"""Plain PyTorch reference of the Scene Diffusion Model (SDM) of LSDM.

The published model (``model/sdm.py`` with ``util/model_util.py:26-73``
``get_default_model_proxd``; PointNet++ ``model/pcd_backbone/pointnet2*.py``;
the POSA decoder ``posa/posa_models.py:292-326``; the DDPM of
``diffusion/gaussian_diffusion.py``) written as functions over a state
dict, with torch operations only: no kernel, cache or batching of the
program under test, and nothing imported from it.  The benchmark checks the
program's timed outputs against it.

Parameter names are the published model's ``state_dict`` keys
(:func:`param_spec`).  Reference quirks that trained weights depend on are
kept: the float 0/1 object mask ADDED to the cross-attention logits and read
head-major, the row-major "scrambling" reshapes, ``OutputProcess``'s two
GELUs and ``predict_cat``'s softmax, whose probabilities the loss passes
through ``log_softmax`` again.

Precision (:class:`Precision`): ``"float32"`` computes every product in
float32 (the caller keeps TF32 off); ``"bfloat16"`` is flax's casts, which
the configuration states: every Dense casts its input, weight and bias to
bf16 and returns bf16, BatchNorm and GroupNorm normalise in float32, the
attention's logits and softmax are float32 with the weights rounded to
bf16 before the value product.  The sampling loop of a bf16 model takes
the products of each step on bf16 operands summed in float32, with float32
biases, activations and update (the mode of the loop kernel that
``sample_sdm`` runs), its step rows from the bf16 model.  ``fp8=True``
(the control of a bf16 configuration) rounds both operands of every
product to float8 e4m3 with a per-tensor scale first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
GN_EPS = 1e-5
BF16_RSQRT2 = 0.70703125  # 1/sqrt(2) rounded to bf16, as flax's bf16 GELU
DROPOUT_KEEP = 0.5
FP8_MAX = 448.0  # largest float8 e4m3 value


@dataclasses.dataclass(frozen=True)
class Widths:
    """The SDM's sizes (``get_default_model_proxd``)."""

    clip_dim: int = 512
    n_head: int = 8
    cat_emb: int = 32
    latent_dim: int = 128
    vert_dims: int = 655
    pcd_points: int = 1024
    pcd_dim: int = 3
    xyz_dim: int = 3
    max_cats: int = 13
    translation_params: int = 12
    max_objs: int = 9

    @property
    def sa(self) -> List[Tuple[int, float, int, List[int]]]:
        """(npoint, radius, in_channel, mlp) of the four SA stages."""
        N = self.pcd_points
        return [(N, 0.1, 3 + 3, [32, 32, 64]),
                (max(N // 4, 4), 0.2, 64 + 3, [64, 64, 128]),
                (max(N // 16, 2), 0.4, 128 + 3, [128, 128, 256]),
                (max(N // 64, 1), 0.8, 256 + 3, [256, 256, 512])]

    @property
    def nsample(self) -> int:
        return min(32, self.pcd_points)

    # (name, in_channel, mlp) of the four FP stages, in the order they run
    FP = (("fp4", 768, [256, 256]), ("fp3", 384, [256, 256]),
          ("fp2", 320, [256, 128]), ("fp1", 128, [128, 128, 128]))


def widths_of(cfg: dict) -> Widths:
    """The :class:`Widths` named in a configuration's ``model`` block."""
    return Widths(**{f.name: cfg[f.name] for f in dataclasses.fields(Widths)
                     if f.name in cfg})


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: str = "float32"  # "float32" | "bfloat16"
    fp8: bool = False

    @property
    def bf16(self) -> bool:
        return self.dtype == "bfloat16"


# ----------------------------------------------------------------------
# parameters


def _mlp_spec(prefix: str, fin: int, outs) -> List[Tuple[str, tuple, str]]:
    spec = []
    for i, f in enumerate(outs):
        spec += [(f"{prefix}.{2 * i}.weight", (f, fin), "linear"),
                 (f"{prefix}.{2 * i}.bias", (f,), "linear_bias")]
        fin = f
    return spec


def _bn_spec(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "ones"), (f"{prefix}.bias", (c,), "zeros"),
            (f"{prefix}.running_mean", (c,), "stat_zeros"),
            (f"{prefix}.running_var", (c,), "stat_ones"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def _mha_spec(prefix: str, E: int, kdim: int, vdim: int):
    return [(f"{prefix}.q_proj_weight", (E, E), "xavier"),
            (f"{prefix}.k_proj_weight", (E, kdim), "xavier"),
            (f"{prefix}.v_proj_weight", (E, vdim), "xavier"),
            (f"{prefix}.in_proj_bias", (3 * E,), "zeros"),
            (f"{prefix}.out_proj.weight", (E, E), "linear"),
            (f"{prefix}.out_proj.bias", (E,), "linear_bias")]


def param_spec(w: Widths) -> List[Tuple[str, tuple, str]]:
    """Every entry of the model's ``state_dict``: (name, shape, kind), in the
    published model's order.  Kinds: ``linear`` U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) with ``linear_bias`` at the bound of the weight before
    it, ``xavier`` Xavier-uniform, ``ones``, ``zeros``; the buffers
    ``stat_zeros`` and ``stat_ones`` (running statistics), ``count`` (an
    int64 0) and ``pe`` (the sinusoidal table)."""
    D, N = w.latent_dim, w.pcd_points
    spec = [("sequence_pos_encoder.pe", (5000, 1, D), "pe")]
    spec += _mlp_spec("embed_timestep.time_embed", D, [D, D])
    spec += _mlp_spec("embed_text", w.clip_dim, [w.clip_dim // 2, 2 * D, D])
    spec += _mlp_spec("embed_cat", w.max_cats, [w.cat_emb])
    spec += _mlp_spec("predict_cat", D, [D // 2, D // 4, w.max_cats])
    spec += _mha_spec("attn_layer", D, w.cat_emb, N * w.pcd_dim)
    spec += _mlp_spec("translation_layer", D + w.cat_emb, [D, w.translation_params])
    spec += _mlp_spec("point_wise_trans_layer", w.translation_params + w.xyz_dim,
                      [w.xyz_dim])
    tp = w.translation_params
    spec += _mha_spec("pcd_attention", tp, w.xyz_dim, w.xyz_dim)
    for i, (_, _, cin, mlp) in enumerate(w.sa, start=1):
        convs, bns = [], []
        for j, out in enumerate(mlp):
            convs += [(f"pcd_backbone.sa{i}.mlp_convs.{j}.weight", (out, cin, 1, 1), "linear"),
                      (f"pcd_backbone.sa{i}.mlp_convs.{j}.bias", (out,), "linear_bias")]
            bns += _bn_spec(f"pcd_backbone.sa{i}.mlp_bns.{j}", out)
            cin = out
        spec += convs + bns
    for name, cin, mlp in Widths.FP:
        convs, bns = [], []
        for j, out in enumerate(mlp):
            convs += [(f"pcd_backbone.{name}.mlp_convs.{j}.weight", (out, cin, 1), "linear"),
                      (f"pcd_backbone.{name}.mlp_convs.{j}.bias", (out,), "linear_bias")]
            bns += _bn_spec(f"pcd_backbone.{name}.mlp_bns.{j}", out)
            cin = out
        spec += convs + bns
    spec += [("pcd_backbone.conv1.weight", (128, 128, 1), "linear"),
             ("pcd_backbone.conv1.bias", (128,), "linear_bias")]
    spec += _bn_spec("pcd_backbone.bn1", 128)
    spec += [("pcd_backbone.conv2.weight", (w.pcd_dim, 128, 1), "linear"),
             ("pcd_backbone.conv2.bias", (w.pcd_dim,), "linear_bias")]
    hb = "human_backbone.de_spiral"
    for i, (fin, fout) in enumerate([(3, 64), (64, 64), (64, 64)]):
        spec += [(f"{hb}.{i}.conv.layer.weight", (fout, fin), "linear"),
                 (f"{hb}.{i}.conv.layer.bias", (fout,), "linear_bias"),
                 (f"{hb}.{i}.norm.weight", (fout,), "ones"),
                 (f"{hb}.{i}.norm.bias", (fout,), "zeros")]
    spec += [(f"{hb}.3.layer.weight", (3, 64), "linear"),
             (f"{hb}.3.layer.bias", (3,), "linear_bias")]
    spec += _mlp_spec("upsampling_layer", 1, [128, 512, N])
    spec += _mlp_spec("combine_extraction", 2 * D, [D])
    spec += _mlp_spec("input_process.pose_embedding", w.xyz_dim, [D // 2, D])
    spec += _mlp_spec("input_process.combination_extraction", 2 * D,
                      [int(D * 1.5), D])
    spec += _mlp_spec("output_process.pose_final", D, [D // 2, w.xyz_dim])
    return spec


def positional_encoding(d_model: int, max_len: int = 5000) -> torch.Tensor:
    """Interleaved sin/cos table (max_len, 1, d_model), float32
    (``model/diffusion_utils.py:24-37``)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)[:, None, :]


# ----------------------------------------------------------------------
# precision-aware building blocks


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in its
    dtype."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(t.dtype)


def wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def lin(P: Precision, x, w, b=None):
    """A Dense layer: ``x @ w.T + b``; in bf16 flax's casts (the product
    rounded to bf16, then the bf16 bias added)."""
    if w.dim() > 2:
        w = w.reshape(w.shape[0], -1)
    if not P.bf16:
        if P.fp8:
            x, w = _fp8(x), _fp8(w)
        return F.linear(x, w, b)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if P.fp8:
        x, w = _fp8(x), _fp8(w)
    y = x @ w.t()
    return y if b is None else y + b.to(torch.bfloat16)


def gelu(x):
    if x.dtype == torch.bfloat16:
        return (x * 0.5) * torch.special.erfc(x * -BF16_RSQRT2)
    return F.gelu(x)


def sigmoid(x):
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def silu(x):
    return x * sigmoid(x) if x.dtype == torch.bfloat16 else F.silu(x)


def mlp(P, sd, prefix, x, n, act=gelu):
    for i in range(n):
        x = act(lin(P, x, sd[f"{prefix}.{2 * i}.weight"], sd[f"{prefix}.{2 * i}.bias"]))
    return x


# ----------------------------------------------------------------------
# point-cloud selection (pointnet2_utils.py), float32, elementwise


def square_distance(src, dst):
    """(B, N, M) squared distances as ``(-2 src.dst + |src|^2) + |dst|^2``,
    each product and sum its own float32 op."""
    s = [src[..., c] for c in range(3)]
    d = [dst[..., c] for c in range(3)]
    dot = ((s[0][:, :, None] * d[0][:, None, :] + s[1][:, :, None] * d[1][:, None, :])
           + s[2][:, :, None] * d[2][:, None, :])
    ss = (s[0] * s[0] + s[1] * s[1]) + s[2] * s[2]
    dd = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    return (-2.0 * dot + ss[:, :, None]) + dd[:, None, :]


def farthest_point_sample(xyz, npoint):
    """FPS from index 0: the running minimum of ``sum((x - c)^2)``, first
    maximum (``pointnet2_utils.py:60-81``)."""
    B, N, _ = xyz.shape
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = torch.zeros(B, dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    out = []
    for _ in range(npoint):
        out.append(far)
        diff = xyz - xyz[rows, far][:, None, :]
        sq = diff * diff
        dist = torch.minimum(dist, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        far = torch.argmax(dist, dim=-1)
    return torch.stack(out, dim=1)


def ball_query(radius, nsample, xyz, new_xyz, block=64):
    """The first ``nsample`` in-radius indices in index order, empty slots
    repeating the first (``pointnet2_utils.py:84-104``); in blocks of
    clouds."""
    B, N, _ = xyz.shape
    r2 = float(np.float32(float(radius) ** 2))
    iota = torch.arange(N, device=xyz.device)
    parts = []
    for i in range(0, B, block):
        d = square_distance(new_xyz[i:i + block], xyz[i:i + block])
        cand = torch.where(d <= r2, iota, N)
        idx = torch.sort(cand, dim=-1).values[..., :nsample]
        idx = torch.where(idx == N, idx[..., :1], idx)
        parts.append(idx.clamp(0, N - 1))
    return torch.cat(parts)


def three_nn(xyz1, xyz2, k=3):
    """Distances and indices of each target's k nearest sources: k passes
    of (minimum, lowest index, mask out)."""
    S = xyz2.shape[1]
    cur = square_distance(xyz1, xyz2)
    iota = torch.arange(S, device=xyz1.device)
    dists, idxs = [], []
    for _ in range(k):
        m = cur.min(dim=-1, keepdim=True).values
        sel = torch.where(cur == m, iota, S).min(dim=-1, keepdim=True).values
        dists.append(m)
        idxs.append(sel)
        cur = torch.where(iota == sel, torch.inf, cur)
    return torch.cat(dists, -1), torch.cat(idxs, -1)


def gather(points, idx):
    """points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B, N, C = points.shape
    flat = idx.reshape(B, -1).long()[..., None].expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


# ----------------------------------------------------------------------
# backbones


def batch_norm(sd, prefix, x, train):
    """BatchNorm over the trailing channel axis in flax's order, in at
    least float32; in training the batch's statistics with the biased
    variance E[x^2] - E[x]^2."""
    xs = wide(x)
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = xs.mean(dim=dims)
        var = torch.clamp_min((xs * xs).mean(dim=dims) - mean * mean, 0.0)
    else:
        mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
    return (xs - mean) * (torch.rsqrt(var + BN_EPS) * sd[f"{prefix}.weight"]) + sd[f"{prefix}.bias"]


def _stage_mlp(P, sd, prefix, x, n, train):
    for j in range(n):
        x = lin(P, x, sd[f"{prefix}.mlp_convs.{j}.weight"], sd[f"{prefix}.mlp_convs.{j}.bias"])
        x = F.relu(batch_norm(sd, f"{prefix}.mlp_bns.{j}", x, train))
    return x


def _attend_block(fn, n, block, *arrays):
    return torch.cat([fn(*(a[i:i + block] for a in arrays)) for i in range(0, n, block)])


def set_abstraction(P, sd, prefix, w, stage, xyz, points, train):
    npoint, radius, _, mlp_w = stage
    N = xyz.shape[1]
    if npoint == N:
        new_xyz = xyz  # FPS of every point selects every point
    else:
        new_xyz = gather(xyz, farthest_point_sample(xyz, npoint))
    idx = ball_query(radius, min(w.nsample, N), xyz, new_xyz)
    base = torch.cat([xyz, points], dim=-1)
    if P.bf16:
        base = base.to(torch.bfloat16)
    grouped = gather(base, idx)
    center = new_xyz[:, :, None, :].to(grouped.dtype)
    new_points = torch.cat([grouped[..., :3] - center, grouped[..., 3:]], dim=-1)
    return new_xyz, _stage_mlp(P, sd, prefix, new_points, len(mlp_w), train).amax(dim=2)


def feature_propagation(P, sd, prefix, n, xyz1, xyz2, points1, points2, train):
    if xyz2.shape[1] == 1:
        interpolated = points2.expand(-1, xyz1.shape[1], -1)
    else:
        k = min(3, xyz2.shape[1])
        dists, idx = three_nn(xyz1.detach(), xyz2.detach(), k)
        if train:  # the distances at the indices, differentiable
            dists = ((xyz1[:, :, None, :] - gather(xyz2, idx)) ** 2).sum(-1)
        recip = 1.0 / (dists + 1e-8)
        weight = recip / recip.sum(dim=2, keepdim=True)
        interpolated = (gather(points2, idx) * weight[..., None]).sum(dim=2)
    x = interpolated if points1 is None else torch.cat([points1, interpolated], dim=-1)
    return _stage_mlp(P, sd, prefix, x, n, train)


def pointnet2(P, sd, w, xyz, train=False, dropout_mask=None):
    """Per-point features (B, N, pcd_dim) of clouds xyz (B, N, 3)."""
    pre = "pcd_backbone"
    xyzs, feats = [xyz], [xyz]
    for i, stage in enumerate(w.sa, start=1):
        nx, nf = set_abstraction(P, sd, f"{pre}.sa{i}", w, stage, xyzs[-1], feats[-1], train)
        xyzs.append(nx)
        feats.append(nf)
    l0, l1, l2, l3, l4 = xyzs
    f1, f2, f3, f4 = feats[1:]
    fp = {name: len(m) for name, _, m in Widths.FP}
    f3 = feature_propagation(P, sd, f"{pre}.fp4", fp["fp4"], l3, l4, f3, f4, train)
    f2 = feature_propagation(P, sd, f"{pre}.fp3", fp["fp3"], l2, l3, f2, f3, train)
    f1 = feature_propagation(P, sd, f"{pre}.fp2", fp["fp2"], l1, l2, f1, f2, train)
    f0 = feature_propagation(P, sd, f"{pre}.fp1", fp["fp1"], l0, l1, None, f1, train)
    x = lin(P, f0, sd[f"{pre}.conv1.weight"], sd[f"{pre}.conv1.bias"])
    x = F.relu(batch_norm(sd, f"{pre}.bn1", x, train))
    if train:
        x = torch.where(dropout_mask, x / DROPOUT_KEEP, 0.0)
    return lin(P, x, sd[f"{pre}.conv2.weight"], sd[f"{pre}.conv2.bias"])


def posa_decoder(P, sd, w, verts):
    """The human backbone: per-vertex linears with GroupNorm + ReLU, the
    identity-spiral block and linear over the first ``vert_dims`` points,
    then nearest x2 upsampling cut to ``pcd_points``."""
    pre = "human_backbone.de_spiral"

    def block(i, x):
        x = lin(P, x, sd[f"{pre}.{i}.conv.layer.weight"], sd[f"{pre}.{i}.conv.layer.bias"])
        x = F.group_norm(wide(x).transpose(1, 2), 8, sd[f"{pre}.{i}.norm.weight"],
                         sd[f"{pre}.{i}.norm.bias"], eps=GN_EPS).transpose(1, 2)
        return F.relu(x)

    x = block(1, block(0, verts))
    x = block(2, x[:, :w.vert_dims])
    x = lin(P, x, sd[f"{pre}.3.layer.weight"], sd[f"{pre}.3.layer.bias"])
    return torch.repeat_interleave(x, 2, dim=-2)[:, :w.pcd_points]


def mha_weights(P, sd, prefix, query, key, n_head, attn_mask):
    """Head-averaged attention weights (B, L, S) with an additive mask of
    (B * H, L, S)."""
    E = sd[f"{prefix}.q_proj_weight"].shape[0]
    b = sd[f"{prefix}.in_proj_bias"]
    q = wide(lin(P, query, sd[f"{prefix}.q_proj_weight"], b[:E]))
    k = wide(lin(P, key, sd[f"{prefix}.k_proj_weight"], b[E:2 * E]))
    B, L, _ = q.shape
    S, H = k.shape[1], n_head
    Dh = E // H
    scale = 1.0 / math.sqrt(Dh)
    qh = q.reshape(B, L, H, Dh).transpose(1, 2)
    kh = k.reshape(B, S, H, Dh).transpose(1, 2)
    logits = (qh * scale) @ kh.transpose(-1, -2) + attn_mask.reshape(B, H, L, S)
    return torch.softmax(logits, dim=-1).mean(dim=1)


def rank1_attention(P, sd, prefix, query, kv, block=8):
    """Attention with one scalar a head (embed_dim == heads), in blocks of
    clouds: softmax_s(q_h k_h[s]) v_h, then the output projection."""
    E = sd[f"{prefix}.q_proj_weight"].shape[0]
    b = sd[f"{prefix}.in_proj_bias"]
    q = wide(lin(P, query, sd[f"{prefix}.q_proj_weight"], b[:E]))
    k = wide(lin(P, kv, sd[f"{prefix}.k_proj_weight"], b[E:2 * E]))
    v = wide(lin(P, kv, sd[f"{prefix}.v_proj_weight"], b[2 * E:]))

    def attend(q, k, v):
        wts = torch.softmax(torch.einsum("blh,bsh->bhls", q, k), dim=-1)
        if P.bf16:
            wts = wts.to(torch.bfloat16).to(wts.dtype)
        return torch.einsum("bhls,bsh->blh", wts, v)

    out = _attend_block(attend, q.shape[0], block, q, k, v)
    return lin(P, out, sd[f"{prefix}.out_proj.weight"], sd[f"{prefix}.out_proj.bias"])


# ----------------------------------------------------------------------
# the denoiser


@dataclasses.dataclass
class Cond:
    enc_text: torch.Tensor  # (B, 1, D)
    out_cat: torch.Tensor  # (B, 1, max_cats), float32 probabilities
    cond_pcd: torch.Tensor  # (B, N, 3)


def encode(P, sd, w, mask, objs, cats, text, train=False, dropout_mask=None,
           attn_block=8):
    """The conditioning (``model/sdm.py:145-161, 169-204``)."""
    B, O, N, _ = objs.shape
    D = w.latent_dim
    enc_text = mlp(P, sd, "embed_text", text.float(), 3)[:, None, :]
    out_cat = torch.softmax(wide(mlp(P, sd, "predict_cat", enc_text.detach(), 3)), dim=2)
    emb_cat = mlp(P, sd, "embed_cat", cats, 1)
    hm_out = posa_decoder(P, sd, w, objs[:, 0])
    pcd_out = pointnet2(P, sd, w, objs.reshape(B * O, N, 3), train, dropout_mask)
    pcd_out = pcd_out.reshape(B, O, N * w.pcd_dim)
    H = w.n_head
    rows = torch.arange(B * H, device=mask.device)
    attn_mask = mask.float()[rows % B][:, None, :]
    attn_w = mha_weights(P, sd, "attn_layer", enc_text, emb_cat, H, attn_mask)
    translation = mlp(P, sd, "translation_layer",
                      torch.cat([emb_cat, enc_text.expand(B, O, D)], dim=-1), 2)
    tp = w.translation_params
    translation = translation[:, :, None, :].expand(B, O, N, tp).reshape(B * O, N, tp)
    pcd_out = pcd_out.transpose(1, 2) * attn_w.to(pcd_out.dtype)
    pcd_out = pcd_out.reshape(B, O, N, w.pcd_dim)
    pcd_trans = rank1_attention(P, sd, "pcd_attention", translation,
                                pcd_out.reshape(B * O, N, w.xyz_dim), attn_block)
    pcd_trans = pcd_trans.reshape(B, O, N, tp)
    pcd_out = mlp(P, sd, "point_wise_trans_layer",
                  torch.cat([pcd_out, pcd_trans.to(pcd_out.dtype)], dim=-1), 1)
    flat = torch.arange(pcd_out.numel(), device=mask.device)
    pcd_out = pcd_out * mask.float().reshape(-1)[flat % mask.numel()].reshape(
        pcd_out.shape).to(pcd_out.dtype)
    cond_pcd = (pcd_out.sum(dim=1) + hm_out) / 2
    return Cond(enc_text, out_cat, cond_pcd)


def _time_embed(P, sd, t):
    """(len(t), 1, D) timestep embeddings: the table's rows, then
    Linear-SiLU-Linear."""
    x = sd["sequence_pos_encoder.pe"][t.long()]
    x = silu(lin(P, x, sd["embed_timestep.time_embed.0.weight"],
                 sd["embed_timestep.time_embed.0.bias"]))
    return lin(P, x, sd["embed_timestep.time_embed.2.weight"],
               sd["embed_timestep.time_embed.2.bias"])


def step_rows(P, sd, cond, t):
    """The (B, 2D) rows [timestep embedding, text embedding] of timesteps t
    (B,)."""
    return torch.cat([_time_embed(P, sd, t), cond.enc_text], dim=-1)[:, 0]


def denoise(P, sd, w, cond, x, t):
    """(x0, guiding), both at least float32, at timesteps t (B,)
    (``model/sdm.py:141-142, 164-167, 204-217``)."""
    emb = step_rows(P, sd, cond, t)[:, :, None]
    emb = mlp(P, sd, "upsampling_layer", emb, 3).transpose(1, 2)
    emb = mlp(P, sd, "combine_extraction", emb, 1)

    def tail(inp):
        h = mlp(P, sd, "input_process.pose_embedding", inp.float(), 2, act=sigmoid)
        h = mlp(P, sd, "input_process.combination_extraction",
                torch.cat([h, emb.to(h.dtype)], dim=-1), 2, act=sigmoid)
        return wide(mlp(P, sd, "output_process.pose_final", h, 2))

    return tail(x + cond.cond_pcd), tail(cond.cond_pcd)


# ----------------------------------------------------------------------
# the sampling loop


def cosine_betas(T: int) -> np.ndarray:
    """The cosine schedule's betas, float64 (``gaussian_diffusion.py:22-66``)."""
    def alpha_bar(s):
        return math.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2
    t = np.arange(T, dtype=np.float64)
    ab1 = np.array([alpha_bar(x) for x in t / T])
    ab2 = np.array([alpha_bar(x) for x in (t + 1) / T])
    return np.minimum(1.0 - ab2 / ab1, 0.999)


def schedule(T: int, device) -> Dict[str, torch.Tensor]:
    """The DDPM tables the sampler and the loss read, float32."""
    betas = cosine_betas(T)
    ac = np.cumprod(1.0 - betas)
    acp = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - acp) / (1.0 - ac)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return {"sqrt_ac": f32(np.sqrt(ac)), "sqrt_1m_ac": f32(np.sqrt(1.0 - ac)),
            "coef1": f32(betas * np.sqrt(acp) / (1.0 - ac)),
            "coef2": f32((1.0 - acp) * np.sqrt(1.0 - betas) / (1.0 - ac)),
            "log_var": f32(np.log(np.append(post_var[1], post_var[1:])))}


def _loop_matmul(P, a, b):
    """A product of the sampling loop: float32; bf16 operands summed in
    float32 for a bf16 model (fp8 operands for its control)."""
    if P.fp8:
        a, b = _fp8(a.float()), _fp8(b.float())
    if P.bf16:
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    return a @ b


def loop_step(P, sd, x, noise, cond_pcd, e2, coefs):
    """One DDPM step of the x0-predicting model: the denoiser on step rows
    e2 (B, 2D), then x_{t-1} = c1 x0 + c2 x_t + c3 noise."""
    def layer(inp, name, act):
        return act(_loop_matmul(P, inp, sd[f"{name}.weight"].t()) + sd[f"{name}.bias"])
    u = F.gelu(e2[..., None] * sd["upsampling_layer.0.weight"][:, 0] + sd["upsampling_layer.0.bias"])
    u = layer(u, "upsampling_layer.2", F.gelu)  # (B, 2D, 512)
    u = layer(u, "upsampling_layer.4", F.gelu)  # (B, 2D, N)
    emb = layer(u.transpose(1, 2), "combine_extraction.0", F.gelu)  # (B, N, D)
    h = layer(x + cond_pcd, "input_process.pose_embedding.0", torch.sigmoid)
    h = layer(h, "input_process.pose_embedding.2", torch.sigmoid)
    h = layer(torch.cat([h, emb], dim=-1), "input_process.combination_extraction.0", torch.sigmoid)
    h = layer(h, "input_process.combination_extraction.2", torch.sigmoid)
    h = layer(h, "output_process.pose_final.0", F.gelu)
    x0 = layer(h, "output_process.pose_final.2", F.gelu)
    return coefs[0] * x0 + coefs[1] * x + coefs[2] * noise


@torch.no_grad()
def sample(P, sd, w, T, mask, objs, cats, text, x_init, noise):
    """DDPM ancestral sampling over all T steps from x_init (B, N, 3) with
    the draws noise (T, B, N, 3).  Returns (sample, x0, cat, guiding): the
    sample and the denoiser's output at the last step's input."""
    cond = encode(P, sd, w, mask, objs, cats, text)
    dev = objs.device
    sch = schedule(T, dev)
    t_seq = torch.arange(T - 1, -1, -1, device=dev)
    nzm = (t_seq != 0).float()
    coef = torch.stack([sch["coef1"][t_seq], sch["coef2"][t_seq],
                        torch.exp(0.5 * sch["log_var"][t_seq]) * nzm], dim=-1)
    B = objs.shape[0]
    emb_t = _time_embed(P, sd, t_seq)[:, 0]  # (T, D)
    cond_pcd = cond.cond_pcd.float()
    x = x_init
    last_in = x_init
    for i in range(T):
        e2 = torch.cat([emb_t[i].expand(B, -1), cond.enc_text[:, 0]], dim=-1).float()
        last_in = x
        x = loop_step(P, sd, x, noise[i], cond_pcd, e2, coef[i])
    x0, guiding = denoise(P, sd, w, cond, last_in, t_seq[-1].expand(B))
    return x, x0, cond.out_cat, guiding


# ----------------------------------------------------------------------
# training


def chamfer(x, y):
    """Bidirectional chamfer distance, point mean and batch mean."""
    d = square_distance(x.float(), y.float())
    return (d.amin(dim=2).mean(dim=1) + d.amin(dim=1).mean(dim=1)).mean()


def train_loss(P, sd, w, T, batch, t, noise, dropout_mask, lambda_cat=0.1):
    """The LSDM training loss (``gaussian_diffusion.py:1256-1342``):
    chamfer(x0, x_start) + lambda_cat * CE(log_softmax(probabilities))."""
    mask, objs, cats, target, target_cat, text = batch
    sch = schedule(T, target.device)
    x_t = sch["sqrt_ac"][t][:, None, None] * target + sch["sqrt_1m_ac"][t][:, None, None] * noise
    cond = encode(P, sd, w, mask, objs, cats, text, train=True, dropout_mask=dropout_mask)
    x0, _ = denoise(P, sd, w, cond, x_t, t)
    log_probs = torch.log_softmax(cond.out_cat[:, 0], dim=-1)
    cat_loss = lambda_cat * -log_probs.gather(1, target_cat.argmax(dim=1)[:, None]).mean()
    return chamfer(x0, target) + cat_loss


class AdamW:
    """AdamW as the reference trainer's ``torch.optim.AdamW``, by hand:
    decay, then the bias-corrected Adam step."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float):
        self.params, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.eps, self.wd, self.step_count = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.step_count += 1
        bc1 = 1 - self.b1 ** self.step_count
        bc2 = 1 - self.b2 ** self.step_count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - self.lr * self.wd)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def is_param(kind: str) -> bool:
    """Whether a :func:`param_spec` entry is a trained parameter (not a
    running statistic, a count or the sinusoidal table)."""
    return kind in ("linear", "linear_bias", "xavier", "ones", "zeros")


def train_steps(P, sd, w, T, steps, lambda_cat, opt_cfg):
    """Follow ``steps`` train steps, each ``(batch, t, noise, dropout_mask)``,
    from the weights ``sd`` with AdamW at ``opt_cfg`` (lr, betas, eps,
    weight_decay).  Returns (losses, first gradients, parameters after the
    last step), the gradients and parameters by name."""
    names = [n for n, _, kind in param_spec(w) if is_param(kind)]
    params = {n: sd[n].detach().clone().float() for n in names}
    b1, b2 = opt_cfg["betas"]
    opt = AdamW(params, opt_cfg["lr"], b1, b2, opt_cfg["eps"], opt_cfg["weight_decay"])
    losses, first = [], None
    for batch, t, noise, dmask in steps:
        live = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        full = dict(sd)
        full.update(live)
        loss = train_loss(P, full, w, T, batch, t, noise, dmask, lambda_cat)
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(live[n])).detach()
                 for n, g in zip(live, grads)}
        if first is None:
            first = grads
        losses.append(float(loss.detach()))
        opt.step(grads)
    return losses, first, params
