"""Shared building blocks, channels-last (NHWC) like the JAX package.

Counterpart of ``padel_analytics_tpu/models/layers.py``. Parameters keep
PyTorch's own layouts (Conv2d weight OIHW, BatchNorm2d buffers) under the
Flax tree's names (``conv``, ``bn``), which are also the reference
checkpoint's names, so either source loads with `load_state_dict`.
"""

from __future__ import annotations

import contextlib
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
from ..parallel.tensor_parallel import refuse_sharded, sharded_call


@contextlib.contextmanager
def batch_stats_over(model: nn.Module, mesh):
    """Inside the block, the train-mode BatchNorms of `model`'s ConvBNs
    reduce their batch statistics over every rank of `mesh`'s 'data' axis
    (parallel/mesh.py): the global batch the JAX package's sharded train
    step sees. Over 'model' they are replicated (each model rank holds the
    gathered channels). mesh None keeps them this process's."""
    convs = [m for m in model.modules() if isinstance(m, ConvBN)]
    for m in convs:
        m.stats_mesh = mesh
    try:
        yield
    finally:
        for m in convs:
            m.stats_mesh = None


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d, momentum: float,
                     mesh=None) -> torch.Tensor:
    """Flax `nn.BatchNorm(use_running_average=False)` over an (N, C, H, W)
    batch, under autograd: the mean and the fast variance E[y^2] - E[y]^2
    (clipped at 0) reduced in at least fp32 (all-reduced over `mesh`), then
    (y - mean) * (scale * rsqrt(var + eps)) + bias. The running statistics
    take Flax's update, ra = momentum * ra + (1 - momentum) * batch, with
    the biased batch variance (F.batch_norm would put the unbiased one
    there)."""
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    stats = torch.cat([yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3)),
                       yf.new_full((1,), y.numel() // y.shape[1])])
    if mesh is not None:
        stats = mesh.all_reduce_autograd(stats)
    c = y.shape[1]
    n = stats[-1].detach()
    mean = stats[:c] / n
    var = torch.clamp(stats[c: 2 * c] / n - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
        bn.running_var.mul_(momentum).add_((1.0 - momentum) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((yf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]).to(y.dtype)


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + activation.

    In train mode (`self.training`) the conv is F.conv2d and the BatchNorm
    takes its batch statistics and Flax's running update
    (`batch_norm_train`, momentum `bn_momentum` in Flax's convention: 0.9
    here, 0.97 for YOLOv8, 0.99 for ResNet-50), all under autograd; the
    JAX package trains on XLA's convs too, never through its Pallas kernel.
    A conv sharded over the mesh's 'model' axis
    (parallel/tensor_parallel.py) runs on this rank's output channels and
    is gathered before the BatchNorm, which sees every channel.

    In eval mode every stride-1 3x3 block runs as the fused conv + folded-BN
    + act of ops/conv3x3.py: kernel K1 on a CUDA tensor (bf16), the plain
    version on a CPU tensor. The folded scale/bias and the packed kernel weight are
    computed once per weight (cached until the parameters change), not per
    call. Strided and non-3x3 convs use F.conv2d with symmetric k//2
    padding (torch-style (1, 1) at stride 2, as the JAX package pads them
    explicitly), then the folded BN and the activation in fp32 and one cast
    to x's dtype. Eval mode refuses a sharded conv (ValueError naming
    `gather_params`)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, act: str = "relu", bn_eps: float = 1e-5,
                 bn_momentum: float = 0.9):
        super().__init__()
        self.bn_momentum = bn_momentum
        self.stats_mesh = None  # set by batch_stats_over
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride,
                              padding=kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=bn_eps)
        self.act = act
        self.fused = kernel_size == 3 and stride == 1
        self._cache = None

    def _folded(self, packed: bool):
        refuse_sharded(self.conv, "ConvBN in eval mode")
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
            y = sharded_call(self.conv, x.permute(0, 3, 1, 2), lambda x, w, _: F.conv2d(
                x, w, stride=self.conv.stride, padding=self.conv.padding), dim=1)
            y = batch_norm_train(y, self.bn, self.bn_momentum, self.stats_mesh)
            return _act(y, self.act).permute(0, 2, 3, 1)
        if self.fused:
            on_cuda = x.device.type == "cuda"
            w_hwio, scale, bias, wk = self._folded(packed=on_cuda)
            if on_cuda:
                return conv3x3_bn_act_packed(x, wk, scale, bias, self.act)
            return conv3x3_bn_act_plain(x, w_hwio, scale, bias, self.act)
        _, scale, bias, _ = self._folded(packed=False)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.conv.weight.to(x.dtype),
                     stride=self.conv.stride, padding=self.conv.padding)
        # Folded BN and the activation in fp32, one cast last, as K1 does.
        y = _act(y.float() * scale[:, None, None] + bias[:, None, None], self.act)
        return y.to(x.dtype).permute(0, 2, 3, 1)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool over NHWC (VALID: odd edges are dropped)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample over NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _fan_in_init_(model: nn.Module, sample) -> nn.Module:
    """Conv and linear weights `sample(shape) / sqrt(fan_in)`, zero biases,
    identity BatchNorm."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(sample(m.weight.shape) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def lecun_normal_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator`: N(0, 1/fan_in) conv and linear
    weights, zero biases, identity BatchNorm (the JAX package's init,
    untruncated)."""
    return _fan_in_init_(model, lambda shape: torch.randn(shape, generator=generator))


#: The standard deviation of a unit normal truncated at +-2.
_TRUNC2_STD = 0.87962566103423978


def truncated_lecun_normal_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default init (nn.Conv and nn.Dense `lecun_normal`), drawn from
    `generator`: a unit normal truncated at +-2 standard deviations and
    rescaled to variance 1/fan_in, zero biases, identity BatchNorm."""
    def sample(shape):
        w = torch.empty(shape)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w / _TRUNC2_STD

    return _fan_in_init_(model, sample)
