"""STGCN ("P2R") human backbone (``human_backbone_type="P2R"``).

Counterpart of ``lsdm_tpu/models/stgcn.py`` (reference
``model/p2rnet/``): a spatio-temporal graph convolution over V virtual
"joints" (V = pcd_points, the human cloud's points) on the
``virtualroom`` graph, K = 11 spatial partitions of hop distance up to 5,
a temporal window of ``knn = 20`` frames for the positional branch, two
graph blocks, each with its learnable (K, V, V) edge importance, and
``conv_joint`` to V x 3.  The SDM calls it with one frame.

The parameter names are the JAX module's (``pos_embed_0.conv``,
``st_gcn_1.res_conv``, ``edge_importance_0``, ...), so the weight bridge
(``weights.py``) transposes the Dense kernels and reorders the flax
``Conv`` kernels (kh, kw, in, out) as (out, in, kh, kw) and nothing else.
The adjacency stack is a buffer, built once in numpy
(:func:`virtualroom_adjacency`) and moved with the model; it is not in
the ``state_dict`` (the JAX module rebuilds it at every call).

A compute dtype (bf16) is flax's: each Dense and Conv casts its input and
weight to it, each BatchNorm returns float32, and the graph contraction
of a bf16 input with the float32 ``A * importance`` is taken in float32,
as ``jnp.einsum`` promotes it.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.models.dgcnn import batch_norm
from lsdm_tpu_torch.models.pointnet2 import BN_EPS
from lsdm_tpu_torch.ops.attention import Linear, linear, wide

# copied from lsdm_tpu/models/stgcn.py (the port imports nothing of the JAX
# package): the reference's 52 skeleton edges among the first 53 nodes
VIRTUALROOM_EDGES = [
    (0, 1), (1, 3), (3, 5), (5, 19), (0, 2), (2, 4), (4, 6), (6, 20), (0, 7),
    (7, 8), (8, 9), (9, 10), (10, 21), (10, 22), (8, 11), (11, 13), (13, 15),
    (15, 17), (8, 12), (12, 14), (14, 16), (16, 18), (17, 23), (23, 24),
    (24, 25), (17, 26), (26, 27), (27, 28), (17, 29), (29, 30), (30, 31),
    (17, 32), (32, 33), (33, 34), (17, 35), (35, 36), (36, 37), (18, 38),
    (38, 39), (39, 40), (18, 41), (41, 42), (42, 43), (18, 44), (44, 45),
    (45, 46), (18, 47), (47, 48), (48, 49), (18, 50), (50, 51), (51, 52),
]


# copied from lsdm_tpu/models/stgcn.py:virtualroom_adjacency
@functools.lru_cache(maxsize=4)
def virtualroom_adjacency(
    num_node: int = 1024, max_hop: int = 5, center: int = 0
) -> np.ndarray:
    """Spatial-partitioned adjacency stack (K, V, V)
    (reference ``Graph`` with layout='virtualroom', strategy='spatial',
    ``stgcn_layers.py:83-200``), vectorized."""
    A = np.zeros((num_node, num_node))
    for i, j in VIRTUALROOM_EDGES:
        if i < num_node and j < num_node:  # tiny test graphs truncate the skeleton
            A[i, j] = A[j, i] = 1
    np.fill_diagonal(A, 1)

    # hop distances via boolean matrix powers
    hop_dis = np.full((num_node, num_node), np.inf)
    reach = np.eye(num_node, dtype=bool)
    power = np.eye(num_node)
    mats = [reach]
    for _ in range(max_hop):
        power = power @ A
        mats.append(power > 0)
    for d in range(max_hop, -1, -1):
        hop_dis[mats[d]] = d

    adjacency = (hop_dis <= max_hop).astype(np.float64)
    # normalize_digraph: A @ D^-1 (column-degree)
    deg = adjacency.sum(0)
    dn = np.where(deg > 0, 1.0 / deg, 0.0)
    norm_adj = adjacency * dn[None, :]

    dist_c = hop_dis[:, center]
    stacks = []
    for hop in range(max_hop + 1):
        mask_hop = hop_dis == hop
        # reference indexes hop_dis[j, i] vs centers of j and i:
        # a_root: dist(j,c)==dist(i,c); a_close: dist(j,c)>dist(i,c)
        jj, ii = np.meshgrid(dist_c, dist_c, indexing="ij")
        root = np.where(mask_hop & (jj == ii), norm_adj, 0.0)
        close = np.where(mask_hop & (jj > ii), norm_adj, 0.0)
        further = np.where(mask_hop & (jj < ii), norm_adj, 0.0)
        if hop == 0:
            stacks.append(root)
        else:
            stacks.append(root + close)
            stacks.append(further)
    return np.stack(stacks).astype(np.float32)  # (2*max_hop+1, V, V)


class TemporalConv(nn.Module):
    """flax ``nn.Conv`` with a (kt, 1) kernel over (B, T, V, C), stride 1,
    padding kt // 2 on T only, computing in ``dtype``.  The weight is
    torch's (out, in, kt, 1); the kt shifted copies of the input are one
    operand, so the product is rounded once, as the convolution's is."""

    def __init__(self, in_channels: int, out_channels: int, kt: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kt, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.compute_dtype = dtype
        bound = (in_channels * kt) ** -0.5
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, cin, kt, _ = self.weight.shape
        T = x.shape[1]
        if kt > 1:
            xp = F.pad(x, (0, 0, 0, 0, kt // 2, kt // 2))  # zeros on T
            x = torch.cat([xp[:, i:i + T] for i in range(kt)], dim=-1)
        w = self.weight[..., 0].transpose(1, 2).reshape(out, kt * cin)
        return linear(x, w, self.bias, self.compute_dtype)


class ConvTemporalGraphical(nn.Module):
    """Linear to K x C channels, then the contraction ``btvkc,kvw->btwc``
    with the (K, V, V) adjacency stack (JAX ``ConvTemporalGraphical``), in
    at least float32."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_channels, self.kernel_size = out_channels, kernel_size
        self.conv = Linear(in_channels, out_channels * kernel_size, dtype=dtype)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        B, T, V, _ = x.shape
        K, C = self.kernel_size, self.out_channels
        # jnp.einsum promotes a bf16 x to A's float32
        x = x.to(torch.promote_types(x.dtype, A.dtype))
        x = x.reshape(B, T, V, K, C).permute(0, 1, 4, 3, 2).reshape(B * T * C, K * V)
        y = x @ A.to(x.dtype).reshape(K * V, -1)  # (B T C, W)
        return y.reshape(B, T, C, -1).transpose(2, 3)  # (B, T, W, C)


class STGCNBlock(nn.Module):
    """Graph conv + temporal conv + residual (JAX ``STGCNBlock``, stride 1,
    dropout 0)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 residual: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        tk, sk = kernel_size
        self.residual = residual
        if residual and in_channels != out_channels:
            self.res_conv = TemporalConv(in_channels, out_channels, 1, dtype)
            self.res_bn = nn.BatchNorm1d(out_channels, eps=BN_EPS)
        self.gcn = ConvTemporalGraphical(in_channels, out_channels, sk, dtype)
        self.tcn_bn1 = nn.BatchNorm1d(out_channels, eps=BN_EPS)
        self.tcn_conv = TemporalConv(out_channels, out_channels, tk, dtype)
        self.tcn_bn2 = nn.BatchNorm1d(out_channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        if not self.residual:
            res = 0.0
        elif hasattr(self, "res_conv"):
            res = batch_norm(self.res_bn, self.res_conv(x), self.training)
        else:
            res = x
        h = F.relu(batch_norm(self.tcn_bn1, self.gcn(x, A), self.training))
        h = batch_norm(self.tcn_bn2, self.tcn_conv(h), self.training)
        return F.relu(h + res)


class SingleConv(nn.Module):
    """Linear (+ BatchNorm + ReLU) over a sequence, order "cbr" or "c"
    (JAX ``SingleConv``)."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "cbr",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.order = order
        self.conv = Linear(in_channels, out_channels, dtype=dtype)
        if "b" in order:
            self.bn = nn.BatchNorm1d(out_channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if "b" in self.order:
            x = batch_norm(self.bn, x, self.training)
        if "r" in self.order:
            x = F.relu(x)
        return x


class STGCN(nn.Module):
    """Joints (B, V, 3), one frame, or (B, T, V, 3) -> (B, V, out / V) of
    the first frame (JAX ``STGCN``; reference ``model/p2rnet/stgcn.py``)."""

    def __init__(self, joint_num: int = 1024, origin_joint_id: int = 0,
                 knn: int = 20, max_hop: int = 5, out_channels: int = 3072,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.origin, self.knn = origin_joint_id, knn
        A = torch.from_numpy(virtualroom_adjacency(joint_num, max_hop,
                                                   origin_joint_id))
        self.register_buffer("A", A, persistent=False)
        K, V = A.shape[0], joint_num
        self.pos_embed_0 = SingleConv(3, 64, "cbr", dtype)
        self.pos_embed_1 = SingleConv(64, 2, "c", dtype)
        self.sk_feat_0 = SingleConv(3, 64, "cbr", dtype)
        self.sk_feat_1 = SingleConv(64, 2, "c", dtype)
        self.edge_importance_0 = nn.Parameter(torch.ones(K, V, V))
        self.edge_importance_1 = nn.Parameter(torch.ones(K, V, V))
        self.st_gcn_0 = STGCNBlock(2, 64, (3, K), residual=False, dtype=dtype)
        self.st_gcn_1 = STGCNBlock(64, 2, (3, K), dtype=dtype)
        self.conv_joint = Linear(V * 2, out_channels, dtype=dtype)

    def forward(self, joints: torch.Tensor) -> torch.Tensor:
        if joints.dim() == 3:
            joints = joints[:, None]  # (B, 1, V, 3)
        B, T, V, _ = joints.shape
        origin = joints[:, :, self.origin]  # (B, T, 3)
        x = joints - origin[:, :, None, :]

        # the temporal window's frames (reference :110-115), clipped
        window = torch.arange(-self.knn // 2, self.knn // 2, device=joints.device)
        idx = torch.clamp(torch.arange(T, device=joints.device)[:, None] + window,
                          0, T - 1)  # (T, knn)
        rel = origin[:, idx] - origin[:, :, None, :]  # (B, T, knn, 3)

        pe = self.pos_embed_1(self.pos_embed_0(rel.reshape(B, T * self.knn, 3)))
        # jnp.mean sums a bf16 input in float32 and rounds the mean
        pe = wide(pe).reshape(B, T, self.knn, 2).mean(dim=2).to(pe.dtype)
        sf = self.sk_feat_1(self.sk_feat_0(x.reshape(B, T * V, 3)))
        h = sf.reshape(B, T, V, 2) + pe[:, :, None, :]

        h = self.st_gcn_0(h, self.A * self.edge_importance_0)
        h = self.st_gcn_1(h, self.A * self.edge_importance_1)
        # (B, T, V, C) -> (B, V*C, T) -> (B, T, V*C), the JAX module's reshape
        C = h.shape[-1]
        h = h.transpose(1, 2).reshape(B, V * C, T).transpose(1, 2)
        return self.conv_joint(h)[:, 0].reshape(B, V, -1)
