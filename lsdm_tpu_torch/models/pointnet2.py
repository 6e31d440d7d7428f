"""PointNet++ backbone, eval (inference) form.

Counterpart of ``lsdm_tpu/models/pointnet2.py`` (reference
``model/pcd_backbone/pointnet2.py:43-80`` and ``pointnet2_utils.py``):
four SetAbstraction stages (FPS -> ball query -> grouped MLP -> max over
the K samples) 1024 -> 256 -> 64 -> 16 points, four FeaturePropagation
stages (3-NN inverse-distance interpolation) back up, then the conv head.

Layouts are channel-last like the JAX package: grouped features are
(B, S, K, C).  Parameters keep the reference module names and shapes
(``sa1.mlp_convs.0.weight`` is a (out, in, 1, 1) Conv2d weight, the FP and
head convs are (out, in, 1) Conv1d weights, ``mlp_bns``/``bn1`` are
BatchNorms); the 1x1 convolutions run as matrix products over the channel
axis.  BatchNorm always applies its running statistics: this slice
samples, and training (batch statistics) is a later one.

``ball_impl`` selects the neighbour selection: ``"pallas"`` (and ``"auto"``)
use the hand-written kernels (K1 ball query, K2 3-NN, K3 FPS) for CUDA
tensors and their plain versions for CPU tensors; ``"topk"`` forces the
plain versions on any device.  ``"fused"`` runs each eval stage as one
kernel, with the JAX package's gates (its ``models/pointnet2.py``): an SA
stage through K7 (``ops/sa_fused.py``) where it has S % 8 == 0 centers, an
FP stage through K8 (``ops/fp_fused.py``) where it has S > 1 sources and
N % 8 == 0 targets, with the backbone's head and ``conv2`` riding fp1's
launch; a stage that declines runs the ``"pallas"`` path (and fp1 then
applies the head and ``conv2`` as plain layers).  FPS is K3 under both.
Fused stages fold BatchNorm and run only in eval mode (``not training``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.ops.fp_fused import fp_stage_fused_kernel
from lsdm_tpu_torch.ops.pointcloud import (
    farthest_point_sample, index_points, query_ball_point, three_nn_interpolate)
from lsdm_tpu_torch.ops.sa_fused import fold_conv_bn, sa_stage_fused_kernel

BN_EPS = 1e-5
HEAD_ACTS = ("relu", "none")  # the head's ReLU, then conv2 with none


class Conv1x1(nn.Module):
    """A 1x1 Conv1d/Conv2d parameter set, applied to channel-last input."""

    def __init__(self, in_channels: int, out_channels: int, spatial_dims: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *([1] * spatial_dims)))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        bound = in_channels ** -0.5
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.reshape(self.weight.shape[0], -1),
                        self.bias)


def bn_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Running-statistics BatchNorm over the trailing channel axis, in
    flax's order: (x - mean) * (scale * rsqrt(var + eps)) + bias."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return (x - bn.running_mean) * mul + bn.bias


def fold_mlp(stage: nn.Module) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The (W', b') of an SA or FP stage's conv + BatchNorm layers, folded
    (``ops/sa_fused.py:fold_conv_bn``), in order."""
    return [fold_conv_bn(c, b) for c, b in zip(stage.mlp_convs, stage.mlp_bns)]


def _resolve_impl(ball_impl: str) -> str:
    if ball_impl in ("auto", "pallas"):
        return "pallas"  # kernels for CUDA tensors, plain versions on the CPU
    if ball_impl in ("topk", "fused"):
        return ball_impl
    if ball_impl == "sg":
        raise NotImplementedError(
            "ball_impl='sg' needs the select-gather kernel (K10), not yet "
            "ported: ROADMAP.md queue 2")
    raise NotImplementedError(
        f"ball_impl={ball_impl!r} is a TPU-only formulation, not ported "
        "(ROADMAP.md, 'Not ported')")


class PointNetSetAbstraction(nn.Module):
    """(reference ``pointnet2_utils.py:158-199``)"""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channel: int, mlp: Sequence[int], fps_mode: str = "auto",
                 impl: str = "pallas"):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.fps_mode, self.impl = fps_mode, impl
        self.sel = "pallas" if impl == "fused" else impl  # selection ops
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for out in mlp:
            self.mlp_convs.append(Conv1x1(last, out, 2))
            self.mlp_bns.append(nn.BatchNorm1d(out, eps=BN_EPS))
            last = out

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, C = xyz.shape
        if self.fps_mode == "auto" and self.npoint == N:
            new_xyz = xyz  # FPS of N points out of N selects all of them
        else:
            fps_idx = farthest_point_sample(xyz, self.npoint, impl=self.sel)
            new_xyz = index_points(xyz, fps_idx)  # (B, S, 3)
        # nsample can exceed the points of down-scaled test configs
        nsample = min(self.nsample, N)
        if (self.impl == "fused" and not self.training and points is not None
                and new_xyz.shape[1] % 8 == 0):
            # the whole stage as one kernel (K7): no grouped buffer
            base = torch.cat([xyz, points], dim=-1)
            return new_xyz, sa_stage_fused_kernel(
                self.radius, nsample, xyz, new_xyz, base, fold_mlp(self))
        idx = query_ball_point(self.radius, nsample, xyz, new_xyz,
                               impl=self.sel)
        if points is not None:
            # one gather of the concatenated columns (== gather then concat)
            grouped = index_points(torch.cat([xyz, points], dim=-1), idx)
            new_points = torch.cat(
                [grouped[..., :C] - new_xyz[:, :, None, :], grouped[..., C:]],
                dim=-1)
        else:
            new_points = index_points(xyz, idx) - new_xyz[:, :, None, :]
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            new_points = F.relu(bn_eval(bn, conv(new_points)))
        return new_xyz, new_points.max(dim=2).values  # max over the K samples


class PointNetFeaturePropagation(nn.Module):
    """(reference ``pointnet2_utils.py:262-312``)"""

    def __init__(self, in_channel: int, mlp: Sequence[int],
                 impl: str = "pallas"):
        super().__init__()
        self.impl = impl
        self.sel = "pallas" if impl == "fused" else impl  # selection ops
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for out in mlp:
            self.mlp_convs.append(Conv1x1(last, out, 1))
            self.mlp_bns.append(nn.BatchNorm1d(out, eps=BN_EPS))
            last = out

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor], points2: torch.Tensor,
                extra_folded: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
                extra_acts: Sequence[str] = ()) -> torch.Tensor:
        """``extra_folded``/``extra_acts``: eval-only trailing (W', b')
        layers and their activations ("relu"/"none"), applied after the
        stage's own, inside the fused kernel when the stage fuses."""
        S = xyz2.shape[1]
        if (self.impl == "fused" and not self.training and S > 1
                and xyz1.shape[1] % 8 == 0):
            # the whole stage as one kernel (K8): no gathered buffer
            folded = fold_mlp(self)
            return fp_stage_fused_kernel(
                xyz1, xyz2, points1, points2, folded + list(extra_folded),
                ("relu",) * len(folded) + tuple(extra_acts))
        if S == 1:
            interpolated = points2.expand(-1, xyz1.shape[1], -1)
        else:
            interpolated = three_nn_interpolate(xyz1, xyz2, points2,
                                                impl=self.sel)
        new_points = (interpolated if points1 is None
                      else torch.cat([points1, interpolated], dim=-1))
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            new_points = F.relu(bn_eval(bn, conv(new_points)))
        # the trailing layers when the gate above declined, so fused and
        # composed stages stay interchangeable
        for (w, b), act in zip(extra_folded, extra_acts):
            new_points = new_points @ w + b
            if act == "relu":
                new_points = F.relu(new_points)
        return new_points


class PointNet2Backbone(nn.Module):
    """``get_backbone`` (reference ``pointnet2.py:43-80``): per-point
    features (B, N, out_dim) of clouds (B, N, 3)."""

    def __init__(self, out_dim: int = 3,
                 sa_npoints: Tuple[int, int, int, int] = (1024, 256, 64, 16),
                 sa_nsample: int = 32, fps_mode: str = "auto",
                 ball_impl: str = "auto"):
        super().__init__()
        self.impl = impl = _resolve_impl(ball_impl)
        p1, p2, p3, p4 = sa_npoints
        ns = sa_nsample
        kw = dict(fps_mode=fps_mode, impl=impl)
        self.sa1 = PointNetSetAbstraction(p1, 0.1, ns, 3 + 3, (32, 32, 64), **kw)
        self.sa2 = PointNetSetAbstraction(p2, 0.2, ns, 64 + 3, (64, 64, 128), **kw)
        self.sa3 = PointNetSetAbstraction(p3, 0.4, ns, 128 + 3, (128, 128, 256), **kw)
        self.sa4 = PointNetSetAbstraction(p4, 0.8, ns, 256 + 3, (256, 256, 512), **kw)
        self.fp4 = PointNetFeaturePropagation(768, (256, 256), impl)
        self.fp3 = PointNetFeaturePropagation(384, (256, 256), impl)
        self.fp2 = PointNetFeaturePropagation(320, (256, 128), impl)
        self.fp1 = PointNetFeaturePropagation(128, (128, 128, 128), impl)
        self.conv1 = Conv1x1(128, 128, 1)
        self.bn1 = nn.BatchNorm1d(128, eps=BN_EPS)
        self.conv2 = Conv1x1(128, out_dim, 1)

    def head_folded(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The head (conv1 + bn1, BatchNorm folded) and conv2 as (W', b')
        layers with activations :data:`HEAD_ACTS`."""
        w2 = self.conv2.weight
        return [fold_conv_bn(self.conv1, self.bn1),
                (w2.reshape(w2.shape[0], -1).t().contiguous(), self.conv2.bias)]

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        l0_xyz, l0_points = xyz, xyz
        l1_xyz, l1_points = self.sa1(l0_xyz, l0_points)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points)
        l3_xyz, l3_points = self.sa3(l2_xyz, l2_points)
        l4_xyz, l4_points = self.sa4(l3_xyz, l3_points)
        l3_points = self.fp4(l3_xyz, l4_xyz, l3_points, l4_points)
        l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points)
        if self.impl == "fused" and not self.training:
            # eval: the head and conv2 ride fp1 as two trailing layers
            # (dropout is the identity), so the tail is one launch
            return self.fp1(l0_xyz, l1_xyz, None, l1_points,
                            extra_folded=self.head_folded(),
                            extra_acts=HEAD_ACTS)
        l0_points = self.fp1(l0_xyz, l1_xyz, None, l1_points)
        x = F.relu(bn_eval(self.bn1, self.conv1(l0_points)))
        return self.conv2(x)  # dropout is the identity in eval
