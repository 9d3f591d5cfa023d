"""ResNet-50 court-keypoint regressor, channels-last.

Counterpart of ``padel_analytics_tpu/models/resnet.py``: the reference's
'resnet' court mode is torchvision's resnet50 with its fc replaced by a
Linear(2048 -> 24) and a sigmoid applied by the caller, fed 224x224 frames
normalised with the reference's ImageNet statistics (its mean's 0.465 is
the reference's own typo, kept). Input (N, H, W, 3), output (N, 24) fp32
logits.

Every conv + BatchNorm is a `ConvBN`: the 13 stride-1 3x3 `conv2`s of the
bottlenecks (all but the first block of layers 2-4) run through kernel K1
on CUDA; the stem, the 1x1 convs and the strided 3x3 convs run F.conv2d
with the folded BN in fp32. Submodule names follow the Flax tree's, each
conv and its BN under one ConvBN (``layer1_0.conv1.conv``,
``layer1_0.conv1.bn``, ``layer1_0.down_conv``, ``fc``);
`convert.convert_resnet50_state_dict` renames torchvision's keys.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import sharded_call
from .layers import ConvBN

IMAGENET_MEAN = (0.485, 0.465, 0.406)  # the reference's 0.465 (sic)
IMAGENET_STD = (0.229, 0.224, 0.225)
#: The JAX package's ResNet BatchNorms are Flax's defaults: momentum 0.99.
BN_MOMENTUM = 0.99


class _Bottleneck(nn.Module):
    """1x1 -> 3x3 (the block's stride) -> 1x1 x4, plus the identity or a
    strided 1x1 projection; relu(y + residual) in the compute dtype."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = ConvBN(in_features, features, 1, act="relu", bn_momentum=BN_MOMENTUM)
        self.conv2 = ConvBN(features, features, 3, stride, act="relu", bn_momentum=BN_MOMENTUM)
        self.conv3 = ConvBN(features, features * 4, 1, act="none", bn_momentum=BN_MOMENTUM)
        self.down_conv = (ConvBN(in_features, features * 4, 1, stride, act="none",
                                 bn_momentum=BN_MOMENTUM) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.down_conv is None else self.down_conv(x)
        return torch.relu(y + residual)


class ResNet50Regressor(nn.Module):
    """ResNet-50 trunk + Linear(num_outputs); `stage_sizes` (3, 4, 6, 3) is
    ResNet-50, smaller ones cut its depth (the tests)."""

    def __init__(self, num_outputs: int = 24, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = ConvBN(3, 64, 7, 2, act="relu", bn_momentum=BN_MOMENTUM)
        self.blocks: list[str] = []
        in_features = 64
        for stage, (f, n) in enumerate(zip((64, 128, 256, 512), stage_sizes)):
            for block in range(n):
                name = f"layer{stage + 1}_{block}"
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(name, _Bottleneck(in_features, f, stride, downsample=block == 0))
                self.blocks.append(name)
                in_features = f * 4
        self.fc = nn.Linear(in_features, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        # 3x3 / stride-2 max pool, (1, 1) padding of -inf.
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(1, 2))  # global average pool
        # Sharded over the mesh's 'model' axis where its weight is: the bias
        # added after the gather (parallel/tensor_parallel.py).
        x = sharded_call(self.fc, x, F.linear, dim=-1)
        return x.float()


_STATS: dict = {}


def imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ImageNet (mean, std) as fp32 tensors on `device`,
    uploaded once per device (an upload per call would block the host)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _STATS:
        _STATS[device] = (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
                          torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))
    return _STATS[device]


def imagenet_normalize(images01: torch.Tensor) -> torch.Tensor:
    """Normalise (..., H, W, 3) images in [0, 1] with the reference's
    ImageNet statistics, in fp32."""
    mean, std = imagenet_stats(images01.device)
    return (images01.float() - mean) / std
