"""DGCNN point-cloud backbone (``pcd_backbone_type="DGCNN"``).

Counterpart of ``lsdm_tpu/models/dgcnn.py`` (reference
``model/pcd_backbone/dgcnn.py``): four EdgeConv stages of 64, 64, 128 and
256 channels, each over a dynamic k = 10 nearest-neighbour graph of its
input (:func:`~lsdm_tpu_torch.ops.pointcloud.knn`, self included, ties to
the lowest index), per-edge features ``cat(x_j - x_i, x_i)``, a
Dense-BatchNorm-LeakyReLU(0.2) block and a max over the neighbours; the
four outputs concatenated, ``conv5`` to ``emb_dims``, global max and mean
pooling, and the head ``linear1``/``bn6``/``linear2``/``bn7``/``linear3``
to ``output_channels`` = pcd_points x 3.

The layout is the JAX module's, (B, N, k, C) with Linear layers over the
trailing channel axis, and so are the parameter names (``conv1.conv``,
``conv1.bn``, ..., ``linear1``, ``bn6``): the weight bridge
(``weights.py``) only transposes the Dense kernels.  A compute dtype
(bf16) is flax's: each Linear casts its input and weight to it, each
BatchNorm computes in float32 and returns float32 (``dtype=jnp.float32``
in the JAX module), so the stages, the neighbour graphs and the pooling
stay float32 and only ``linear3``'s output is in the compute dtype.  In
training the BatchNorms take batch statistics (flax's, :func:`bn_train`)
and the head's two dropouts keep the entries of given keep-masks or draw
them from a generator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lsdm_tpu_torch.models.pointnet2 import BN_EPS, bn_eval, bn_train
from lsdm_tpu_torch.ops.attention import Linear
from lsdm_tpu_torch.ops.pointcloud import index_points, knn

STAGES = (64, 64, 128, 256)
DROPOUT_RATE = 0.1


def edge_features(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-edge features ``cat(x_j - x_i, x_i)``: (B, N, C) -> (B, N, k, 2C)
    (reference ``get_graph_feature``, ``dgcnn.py:30-53``)."""
    neigh = index_points(x, knn(x, k))  # (B, N, k, C), self first
    center = x[:, :, None, :].expand_as(neigh)
    return torch.cat([neigh - center, center], dim=-1)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope x)``, whose gradient
    at 0 is 1 (torch's ``leaky_relu`` gives ``slope`` there)."""
    return torch.where(x >= 0, x, slope * x)


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, training: bool
               ) -> torch.Tensor:
    """The JAX module's ``BatchNorm(dtype=float32)``: batch or running
    statistics over every axis but the last, at least float32 out."""
    return bn_train(bn, x) if training else bn_eval(bn, x)


class ConvBNLeaky(nn.Module):
    """Linear (no bias) + BatchNorm + LeakyReLU(0.2) over the trailing axis
    (JAX ``_ConvBNLeaky``)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Linear(in_features, features, bias=False, dtype=dtype)
        self.bn = nn.BatchNorm1d(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(batch_norm(self.bn, self.conv(x), self.training))


def _dropout(x: torch.Tensor, keep_mask: Optional[torch.Tensor],
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout(DROPOUT_RATE)`` in training: keep where ``keep_mask``
    (bool, x's shape) is true, or draw it from ``generator``."""
    keep = 1.0 - DROPOUT_RATE
    if keep_mask is None:
        keep_mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    elif keep_mask.shape != x.shape:
        raise ValueError(f"dropout mask {tuple(keep_mask.shape)} for activations "
                         f"{tuple(x.shape)}")
    return torch.where(keep_mask, x / keep, 0.0)


class DGCNN(nn.Module):
    """Clouds (B, N, 3) -> (B, output_channels / 3, 3) (JAX ``DGCNN``)."""

    def __init__(self, emb_dims: int = 512, k: int = 10,
                 output_channels: int = 3072,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.k = k
        last = 3
        for i, feats in enumerate(STAGES):
            setattr(self, f"conv{i + 1}", ConvBNLeaky(2 * last, feats, dtype))
            last = feats
        self.conv5 = ConvBNLeaky(sum(STAGES), emb_dims, dtype)
        self.linear1 = Linear(2 * emb_dims, 512, bias=False, dtype=dtype)
        self.bn6 = nn.BatchNorm1d(512, eps=BN_EPS)
        self.linear2 = Linear(512, 256, dtype=dtype)
        self.bn7 = nn.BatchNorm1d(256, eps=BN_EPS)
        self.linear3 = Linear(256, output_channels, dtype=dtype)

    def forward(self, x: torch.Tensor,
                dropout_mask: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In training the two dropouts keep where ``dropout_mask`` = (m1
        (B, 512), m2 (B, 256)) is true or, without one, draw their masks
        from ``generator``, m1 first."""
        B, N, _ = x.shape
        k = min(self.k, N)
        outs, h = [], x
        for i in range(len(STAGES)):
            e = getattr(self, f"conv{i + 1}")(edge_features(h, k))  # (B, N, k, C)
            # amax shares a tie's gradient evenly, as JAX's max does
            h = e.amax(dim=2)
            outs.append(h)
        h = self.conv5(torch.cat(outs, dim=-1))  # (B, N, emb_dims)
        g = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)  # (B, 2 emb)
        masks = (None, None) if dropout_mask is None else tuple(dropout_mask)
        g = leaky_relu(batch_norm(self.bn6, self.linear1(g), self.training))
        if self.training:
            g = _dropout(g, masks[0], generator)
        g = leaky_relu(batch_norm(self.bn7, self.linear2(g), self.training))
        if self.training:
            g = _dropout(g, masks[1], generator)
        return self.linear3(g).reshape(B, -1, 3)
