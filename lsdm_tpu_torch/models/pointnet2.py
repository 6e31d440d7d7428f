"""PointNet++ backbone, eval and train forms.

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
axis.  In eval (``not training``) BatchNorm applies its running
statistics; in training it is flax's BatchNorm (:func:`bn_train`: batch
statistics over every axis but the channel, the fast biased variance,
running statistics updated with momentum 0.9), and the head's
``Dropout(0.5)`` drops with an explicit keep-mask or a given generator.

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
``"sg"`` (train or eval) takes each SA stage's selection and gather from
K10 (``ops/sg_fused.py``) where the stage has features and S % 8 == 0
centers, and the ``"pallas"`` path elsewhere, as the JAX package's gate
does.  In training an FP stage on the kernel path recomputes its 3-NN
distances differentiably at the kernel's indices
(``ops/pointcloud.py:three_nn_interpolate``).

``dtype`` (bf16) and ``bn_dtype`` are the JAX module's: each 1x1
convolution casts its input, weight and bias to ``dtype`` and returns it;
an SA stage casts its gathered columns ``[xyz, features]`` to ``dtype``
before the gather (K10's bf16 mode under ``"sg"``) and subtracts the
center rounded to it; each BatchNorm computes its statistics and its
normalisation in float32 from the ``dtype`` input, keeps its running
statistics float32 and returns ``bn_dtype`` (flax's promotion); an FP
stage interpolates in float32 from its sources' features.  Under
``"fused"`` a bf16 stage is K7's or K8's bf16 mode (the JAX stages pass
``compute_dtype=self.dtype``): the stage's input promotes as JAX's
``concatenate`` does (float32 ``xyz`` beside bf16 features gives float32),
and its output is bf16.  A bf16 fused stage keeps its folded weights and
their bf16 copies (``ops/rowmlp.py:Bf16Operands``) from one forward to the
next, made again when a weight or a BatchNorm statistic changes
(:func:`_fused_layers`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import rowmlp
from lsdm_tpu_torch.ops.attention import linear, wide
from lsdm_tpu_torch.ops.fp_fused import fp_stage_fused_kernel
from lsdm_tpu_torch.ops.pointcloud import (
    farthest_point_sample, index_points, query_ball_point, three_nn_interpolate)
from lsdm_tpu_torch.ops.sa_fused import fold_conv_bn, sa_stage_fused_kernel
from lsdm_tpu_torch.ops.sg_fused import select_gather_grouped
from lsdm_tpu_torch.parallel.mesh import all_reduce_sum, batch_stats_group

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch
DROPOUT_RATE = 0.5
HEAD_ACTS = ("relu", "none")  # the head's ReLU, then conv2 with none


class Conv1x1(nn.Module):
    """A 1x1 Conv1d/Conv2d parameter set, applied to channel-last input,
    computing in ``dtype`` (None: the parameters' own)."""

    def __init__(self, in_channels: int, out_channels: int, spatial_dims: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *([1] * spatial_dims)))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.compute_dtype = dtype
        bound = in_channels ** -0.5
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight.reshape(self.weight.shape[0], -1),
                      self.bias, self.compute_dtype)


def _bn_out(y: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    return y if out_dtype is None else y.to(out_dtype)


def bn_eval(bn: nn.BatchNorm1d, x: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Running-statistics BatchNorm over the trailing channel axis, in
    flax's order: (x - mean) * (scale * rsqrt(var + eps)) + bias, in at
    least float32, returned in ``out_dtype`` (None: as computed)."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return _bn_out((x - bn.running_mean) * mul + bn.bias, out_dtype)


def bn_train(bn: nn.BatchNorm1d, x: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``BatchNorm(momentum=0.9)`` in training, over the trailing
    channel axis: the statistics run over every other axis, the variance
    is flax's fast one, ``max(0, E[x^2] - E[x]^2)`` (biased), and the
    running statistics become ``0.9 * running + 0.1 * batch`` with that
    biased variance (torch's ``batch_norm`` would take a two-pass variance
    and update with the unbiased one).  Normalises in flax's order and
    returns ``out_dtype`` (None: as computed).  A bf16 ``x`` is widened to
    float32 for the statistics and, apart, for the normalisation, as flax
    promotes it, so its gradient is the two paths' gradients each rounded
    to bf16 and summed in bf16, as JAX's is.  Inside
    ``parallel.mesh.batch_stats_over(group)`` the statistics are those of
    every rank's rows of ``group`` (a sharded batch), each rank's running
    statistics updated alike."""
    xs = wide(x)
    dims = tuple(range(x.dim() - 1))
    group = batch_stats_group()
    if group is None:
        mean = xs.mean(dim=dims)
        var = torch.clamp_min((xs * xs).mean(dim=dims) - mean * mean, 0.0)
    else:
        # the batch split over ranks (parallel/mesh.py:batch_stats_over):
        # the moments of every rank's rows, as flax takes them over every
        # shard; one differentiable sum of [sum x, sum x^2, count]
        count = xs.new_full((1,), float(xs.numel() // xs.shape[-1]))
        sums = all_reduce_sum(torch.cat([xs.sum(dim=dims), (xs * xs).sum(dim=dims),
                                         count]), group)
        C = xs.shape[-1]
        mean = sums[:C] / sums[-1]
        var = torch.clamp_min(sums[C:2 * C] / sums[-1] - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1 - BN_MOMENTUM) * var)
        bn.num_batches_tracked += 1
    return _bn_out((wide(x) - mean) * (torch.rsqrt(var + bn.eps) * bn.weight)
                   + bn.bias, out_dtype)


def bn_relu(bn: nn.BatchNorm1d, x: torch.Tensor, training: bool,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return F.relu(bn_train(bn, x, out_dtype) if training
                  else bn_eval(bn, x, out_dtype))


def fold_mlp(stage: nn.Module) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The (W', b') of an SA or FP stage's conv + BatchNorm layers, folded
    (``ops/sa_fused.py:fold_conv_bn``), in order."""
    return [fold_conv_bn(c, b) for c, b in zip(stage.mlp_convs, stage.mlp_bns)]


def fold_head(conv1: "Conv1x1", bn1: nn.BatchNorm1d, conv2: "Conv1x1"
              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The backbone's head (conv1 + bn1, BatchNorm folded) and conv2 as
    (W', b') layers with activations :data:`HEAD_ACTS`."""
    w2 = conv2.weight
    return [fold_conv_bn(conv1, bn1),
            (w2.reshape(w2.shape[0], -1).t().contiguous(), conv2.bias)]


def _fused_layers(stage: nn.Module, modules: Sequence[nn.Module], fold, sa: bool):
    """The folded layers of a fused stage that ``fold()`` folds from
    ``modules``: in a bf16 compute dtype with their bf16 copies, kept per
    stage (``rowmlp.kept_bf16_operands``), else ``fold()`` now."""
    if not kernels.bf16_mode(stage.compute_dtype):
        return fold()
    return rowmlp.kept_bf16_operands(stage, modules, fold, sa)


def _resolve_impl(ball_impl: str) -> str:
    if ball_impl in ("auto", "pallas"):
        return "pallas"  # kernels for CUDA tensors, plain versions on the CPU
    if ball_impl in ("topk", "fused", "sg"):
        return ball_impl
    raise NotImplementedError(
        f"ball_impl={ball_impl!r} is a TPU-only formulation, not ported "
        "(ROADMAP.md, 'Not ported')")


class PointNetSetAbstraction(nn.Module):
    """(reference ``pointnet2_utils.py:158-199``)"""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channel: int, mlp: Sequence[int], fps_mode: str = "auto",
                 impl: str = "pallas", dtype: Optional[torch.dtype] = None,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.fps_mode, self.impl = fps_mode, impl
        self.compute_dtype, self.bn_dtype = dtype, bn_dtype
        self.sel = "pallas" if impl in ("fused", "sg") else impl  # selection ops
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for out in mlp:
            self.mlp_convs.append(Conv1x1(last, out, 2, dtype))
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
            folded = _fused_layers(self, (self,), lambda: fold_mlp(self), sa=True)
            return new_xyz, sa_stage_fused_kernel(
                self.radius, nsample, xyz, new_xyz, base, folded,
                self.compute_dtype)
        # the gathered columns, in the compute dtype before the gather
        base = None if points is None else self._cast(torch.cat([xyz, points], dim=-1))
        if (self.impl == "sg" and points is not None
                and new_xyz.shape[1] % 8 == 0):
            # selection + gather + center-relative xyz as one kernel (K10)
            new_points = select_gather_grouped(self.radius, nsample, xyz,
                                               new_xyz, base.contiguous())
            return new_xyz, self._mlp_max(new_points)
        idx = query_ball_point(self.radius, nsample, xyz, new_xyz,
                               impl=self.sel)
        if points is not None:
            # one gather of the concatenated columns (== gather then concat)
            grouped = index_points(base, idx)
            center = new_xyz[:, :, None, :].to(grouped.dtype)
            new_points = torch.cat(
                [grouped[..., :C] - center, grouped[..., C:]], dim=-1)
        else:
            new_points = index_points(xyz, idx) - new_xyz[:, :, None, :]
        return new_xyz, self._mlp_max(new_points)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.compute_dtype is None else t.to(self.compute_dtype)

    def _mlp_max(self, new_points: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            new_points = bn_relu(bn, conv(new_points), self.training,
                                 self.bn_dtype)
        # max over the K samples; amax shares a tie's gradient evenly among
        # the tied samples, as JAX's max does (in bf16, samples that differ
        # can round to one value)
        return new_points.amax(dim=2)


class PointNetFeaturePropagation(nn.Module):
    """(reference ``pointnet2_utils.py:262-312``)"""

    def __init__(self, in_channel: int, mlp: Sequence[int],
                 impl: str = "pallas", dtype: Optional[torch.dtype] = None,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.impl = impl
        self.compute_dtype, self.bn_dtype = dtype, bn_dtype
        self.sel = "pallas" if impl in ("fused", "sg") else impl  # selection ops
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for out in mlp:
            self.mlp_convs.append(Conv1x1(last, out, 1, dtype))
            self.mlp_bns.append(nn.BatchNorm1d(out, eps=BN_EPS))
            last = out

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor], points2: torch.Tensor,
                head: Sequence[nn.Module] = ()) -> torch.Tensor:
        """``head``: eval only, the backbone's (conv1, bn1, conv2), whose
        layers (:func:`fold_head`, activations :data:`HEAD_ACTS`) follow
        the stage's own, inside the fused kernel when the stage fuses."""
        S = xyz2.shape[1]
        acts = ("relu",) * len(self.mlp_convs) + (HEAD_ACTS if head else ())
        if (self.impl == "fused" and not self.training and S > 1
                and xyz1.shape[1] % 8 == 0):
            # the whole stage as one kernel (K8): no gathered buffer
            folded = _fused_layers(
                self, (self, *head),
                lambda: fold_mlp(self) + (fold_head(*head) if head else []),
                sa=False)
            return fp_stage_fused_kernel(xyz1, xyz2, points1, points2, folded,
                                         acts, self.compute_dtype)
        if S == 1:
            interpolated = points2.expand(-1, xyz1.shape[1], -1)
        else:
            interpolated = three_nn_interpolate(xyz1, xyz2, points2,
                                                impl=self.sel,
                                                diff_weights=self.training)
        new_points = (interpolated if points1 is None
                      else torch.cat([points1, interpolated], dim=-1))
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            new_points = bn_relu(bn, conv(new_points), self.training,
                                 self.bn_dtype)
        # the head's layers when the gate above declined, so fused and
        # composed stages stay interchangeable; in a compute dtype JAX's
        # casts: the product in it, the float32 bias, the result cast back
        dt = self.compute_dtype
        for (w, b), act in zip(fold_head(*head) if head else (), HEAD_ACTS):
            if dt is None:
                new_points = new_points @ w + b
            else:
                new_points = (new_points.to(dt) @ w.to(dt)).float() + b
            if act == "relu":
                new_points = F.relu(new_points)
            if dt is not None:
                new_points = new_points.to(dt)
        return new_points


class PointNet2Backbone(nn.Module):
    """``get_backbone`` (reference ``pointnet2.py:43-80``): per-point
    features (B, N, out_dim) of clouds (B, N, 3)."""

    def __init__(self, out_dim: int = 3,
                 sa_npoints: Tuple[int, int, int, int] = (1024, 256, 64, 16),
                 sa_nsample: int = 32, fps_mode: str = "auto",
                 ball_impl: str = "auto", dtype: Optional[torch.dtype] = None,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.impl = impl = _resolve_impl(ball_impl)
        self.bn_dtype = bn_dtype
        p1, p2, p3, p4 = sa_npoints
        ns = sa_nsample
        kw = dict(fps_mode=fps_mode, impl=impl, dtype=dtype, bn_dtype=bn_dtype)
        self.sa1 = PointNetSetAbstraction(p1, 0.1, ns, 3 + 3, (32, 32, 64), **kw)
        self.sa2 = PointNetSetAbstraction(p2, 0.2, ns, 64 + 3, (64, 64, 128), **kw)
        self.sa3 = PointNetSetAbstraction(p3, 0.4, ns, 128 + 3, (128, 128, 256), **kw)
        self.sa4 = PointNetSetAbstraction(p4, 0.8, ns, 256 + 3, (256, 256, 512), **kw)
        kw = dict(impl=impl, dtype=dtype, bn_dtype=bn_dtype)
        self.fp4 = PointNetFeaturePropagation(768, (256, 256), **kw)
        self.fp3 = PointNetFeaturePropagation(384, (256, 256), **kw)
        self.fp2 = PointNetFeaturePropagation(320, (256, 128), **kw)
        self.fp1 = PointNetFeaturePropagation(128, (128, 128, 128), **kw)
        self.conv1 = Conv1x1(128, 128, 1, dtype)
        self.bn1 = nn.BatchNorm1d(128, eps=BN_EPS)
        self.conv2 = Conv1x1(128, out_dim, 1, dtype)

    def head_folded(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The head (conv1 + bn1, BatchNorm folded) and conv2 as (W', b')
        layers with activations :data:`HEAD_ACTS`."""
        return fold_head(self.conv1, self.bn1, self.conv2)

    def forward(self, xyz: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-point features of clouds xyz (B, N, 3).  In training the
        head's dropout keeps the entries where ``dropout_mask`` (bool,
        (B, N, 128)) is true or, without one, draws the keep-mask from
        ``generator``."""
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
                            head=(self.conv1, self.bn1, self.conv2))
        l0_points = self.fp1(l0_xyz, l1_xyz, None, l1_points)
        x = bn_relu(self.bn1, self.conv1(l0_points), self.training,
                    self.bn_dtype)
        if self.training:  # flax Dropout: keep with 1 - rate, scale up
            keep = 1.0 - DROPOUT_RATE
            if dropout_mask is None:
                dropout_mask = torch.rand(x.shape, generator=generator,
                                          device=x.device) < keep
            elif dropout_mask.shape != x.shape:
                raise ValueError(f"dropout mask {tuple(dropout_mask.shape)} "
                                 f"for activations {tuple(x.shape)}")
            x = torch.where(dropout_mask, x / keep, 0.0)
        return self.conv2(x)  # dropout is the identity in eval
