"""Shared building blocks, channels-last (NHWC) like the JAX package.

Counterpart of ``padel_analytics_tpu/models/layers.py``. Parameters keep
PyTorch's own layouts (Conv2d weight OIHW, BatchNorm2d buffers) under the
Flax tree's names (``conv``, ``bn``), which are also the reference
checkpoint's names, so either source loads with `load_state_dict`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import (
    _act,
    conv3x3_bn_act_packed,
    conv3x3_bn_act_plain,
    fold_bn,
    pack_weight,
)


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm (running statistics) + activation, in
    eval mode only.

    Every stride-1 3x3 block runs as the fused conv + folded-BN + act of
    ops/conv3x3.py: kernel K1 on a CUDA tensor (bf16), the plain version on
    a CPU tensor. The folded scale/bias and the packed kernel weight are
    computed once per weight (cached until the parameters change), not per
    call. Strided and non-3x3 convs use F.conv2d with symmetric k//2
    padding: torch-style (1, 1) at stride 2, where Flax's SAME would pad
    (0, 1)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, act: str = "relu", bn_eps: float = 1e-5):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride,
                              padding=kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=bn_eps)
        self.act = act
        self.fused = kernel_size == 3 and stride == 1
        self._cache = None

    def _folded(self, packed: bool):
        params = (self.conv.weight, self.bn.weight, self.bn.bias,
                  self.bn.running_mean, self.bn.running_var)
        # Inference tensors carry no version counter; they cannot change
        # outside inference mode, so their storage identifies them.
        key = tuple((t.data_ptr(), -1 if t.is_inference() else t._version) for t in params)
        if self._cache is None or self._cache[0] != key or (packed and self._cache[4] is None):
            with torch.no_grad():
                w_hwio = self.conv.weight.permute(2, 3, 1, 0)
                scale, bias = fold_bn(self.bn.weight.float(), self.bn.bias.float(),
                                      self.bn.running_mean.float(),
                                      self.bn.running_var.float(), self.bn.eps)
                wk = pack_weight(w_hwio) if packed else None
            self._cache = (key, w_hwio, scale, bias, wk)
        return self._cache[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("ConvBN runs in eval mode only (training is not ported)")
        if self.fused:
            on_cuda = x.device.type == "cuda"
            w_hwio, scale, bias, wk = self._folded(packed=on_cuda)
            if on_cuda:
                return conv3x3_bn_act_packed(x, wk, scale, bias, self.act)
            return conv3x3_bn_act_plain(x, w_hwio, scale, bias, self.act)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.conv.weight.to(x.dtype),
                     stride=self.conv.stride, padding=self.conv.padding)
        y = F.batch_norm(y, self.bn.running_mean, self.bn.running_var, self.bn.weight,
                         self.bn.bias, training=False, eps=self.bn.eps)
        return _act(y, self.act).permute(0, 2, 3, 1)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool over NHWC (VALID: odd edges are dropped)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample over NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def lecun_normal_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator`: N(0, 1/fan_in) conv weights, zero
    conv biases, identity BatchNorm (the JAX package's init, untruncated)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
