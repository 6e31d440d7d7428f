"""Room-layout feature extractors of ATISS: ResNet18 and AlexNet (NCHW).

Counterpart of ``lsdm_tpu/models/feature_extractors.py`` (reference
``atiss/scene_synthesis/networks/feature_extractors.py:27-93``).  The
topologies are written out with ``nn.Conv2d`` (no torchvision):

  * :class:`ResNet18Features`: torchvision's ``resnet18`` with the
    reference's surgery, ``conv1`` rebuilt for ``input_channels``, ``fc``
    replaced by ``Linear(512, 512) + ReLU + Linear(512, feature_size)``,
    adaptive (1, 1) average pooling;
  * :class:`AlexNetFeatures`: torchvision's ``alexnet.features`` with the
    first conv rebuilt and one ``Linear(9216, feature_size)`` on the
    channel-major flatten of the 6 x 6 adaptive pool.

Module names are the reference state_dict's, below the model's
``feature_extractor``: ``_feature_extractor.layer1.0.bn1.running_var``,
``_feature_extractor.features.3.weight``, ``_fc.weight``.

:class:`_BN` frozen (the reference's ``FrozenBatchNorm2d``) takes
``scale = weight * rsqrt(running_var)`` with no epsilon: the reference
folded ``bn.eps`` into ``running_var`` when it froze the layer
(``frozen_batchnorm.py:38``), so a fresh frozen BN starts at variance
``1 + 1e-5``.  Its ``weight`` and ``bias`` are trainable parameters, as
in JAX (buffers in the reference).  Live, it is ``BatchNorm2d``: eps
1e-5 in eval mode, batch statistics and a momentum-0.1 update of the
running ones in train mode (``module.training``, which no entry point
sets: the JAX baseline trainer never passes ``train=True``).

Each extractor's forward runs under ``cudnn_full_fp32``: cuDNN would
take its convolutions in TF32.  The input is (B, C, H, W) or (B, H, W,
C); :func:`to_nchw` tells them apart as the JAX ``to_nhwc`` does.  The
JAX ``adaptive_avg_pool`` is torch's ``F.adaptive_avg_pool2d``.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.models.cudnn import cudnn_full_fp32


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) passes; (B, H, W, C) -> (B, C, H, W).  NCHW is told by
    a 1- or 3-channel second axis and no such last axis, the rule of the
    JAX package's ``to_nhwc``."""
    if x.dim() == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        return x
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


class _BN(nn.Module):
    """BatchNorm2d over NCHW, frozen or live (module docstring)."""

    def __init__(self, features: int, frozen: bool = True):
        super().__init__()
        self.frozen = frozen
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var",
                             torch.full((features,), self.init_var))

    @property
    def init_var(self) -> float:
        return 1.0 + 1e-5 if self.frozen else 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.frozen and self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=True,
                                momentum=0.1, eps=1e-5)
        var = self.running_var if self.frozen else self.running_var + 1e-5
        scale = self.weight * torch.rsqrt(var)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias)


class BasicBlock(nn.Module):
    """torchvision ``BasicBlock``: two 3x3 convs and the identity or a
    1x1 downsample (``downsample.0`` conv, ``downsample.1`` BN)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 frozen_bn: bool = True):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1)
        self.bn1 = _BN(cout, frozen_bn)
        self.conv2 = _conv(cout, cout, 3, 1, 1)
        self.bn2 = _BN(cout, frozen_bn)
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride),
                                         _BN(cout, frozen_bn))
                           if stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


class _ResNet18(nn.Module):
    def __init__(self, input_channels: int, feature_size: int, freeze_bn: bool):
        super().__init__()
        self.conv1 = _conv(input_channels, 64, 7, 2, 3)
        self.bn1 = _BN(64, freeze_bn)
        cin = 64
        for li, w in enumerate((64, 128, 256, 512), start=1):
            stride = 1 if li == 1 else 2
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(cin, w, stride, freeze_bn),
                BasicBlock(w, w, 1, freeze_bn)))
            cin = w
        self.fc = nn.Sequential(nn.Linear(512, 512), nn.ReLU(),
                                nn.Linear(512, feature_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # the -inf padding never wins
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return self.fc(x.mean(dim=(2, 3)))


class ResNet18Features(nn.Module):
    """(reference ``feature_extractors.py:27-52``)"""

    def __init__(self, feature_size: int = 256, freeze_bn: bool = True,
                 input_channels: int = 1):
        super().__init__()
        self._feature_extractor = _ResNet18(input_channels, feature_size,
                                            freeze_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with cudnn_full_fp32():
            return self._feature_extractor(to_nchw(x))


class _AlexNet(nn.Module):
    def __init__(self, input_channels: int):
        super().__init__()
        # torchvision's alexnet.features, Sequential indices kept
        self.features = nn.Sequential(
            _conv(input_channels, 64, 11, 4, 2, True), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            _conv(64, 192, 5, 1, 2, True), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            _conv(192, 384, 3, 1, 1, True), nn.ReLU(),
            _conv(384, 256, 3, 1, 1, True), nn.ReLU(),
            _conv(256, 256, 3, 1, 1, True), nn.ReLU(),
            nn.MaxPool2d(3, 2))


class AlexNetFeatures(nn.Module):
    """(reference ``feature_extractors.py:55-76``)"""

    def __init__(self, feature_size: int = 256, input_channels: int = 1):
        super().__init__()
        self._feature_extractor = _AlexNet(input_channels)
        self._fc = nn.Linear(9216, feature_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with cudnn_full_fp32():
            x = self._feature_extractor.features(to_nchw(x))
        # torch's own geometry, which the JAX package's adaptive_avg_pool
        # reproduces; on 64 x 64 rooms it upsamples 1 x 1 to 6 x 6
        x = F.adaptive_avg_pool2d(x, (6, 6))
        return self._fc(x.reshape(x.shape[0], -1))  # channel-major, as torch
