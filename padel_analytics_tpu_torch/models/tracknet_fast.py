"""TrackNet's inference forward over a Flax variables tree, each 3x3 ConvBN
through the fused conv kernel.

Counterpart of ``padel_analytics_tpu/models/tracknet_fast.py``: the same
`FastTrackNet(out_dim).apply(variables, x)` surface over the JAX package's
TrackNet tree (``{'params', 'batch_stats'}``, as numpy arrays, or as
`core/checkpoint.py` reads it from a ``.msgpack`` file). Each of the 17
stride-1 3x3 ConvBNs folds its BatchNorm (eps 1e-5) into a scale and a bias
and runs as conv + affine + ReLU through `ops/conv3x3.py`: kernel K1 on a
CUDA tensor (bf16 only), its plain version on a CPU tensor. The max pools,
the nearest upsamples, the concats and the 1x1 predictor are plain torch;
the predictor multiplies the compute-dtype activations and kernel in fp32
(the JAX package's fp32 accumulation) and the output is the fp32 sigmoid,
NHWC. The port's `TrackNet` module rounds the predictor's output to the
compute dtype before its sigmoid, so in bf16 the two differ there by up to
one bf16 rounding of the logits.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..ops._fp32 import no_tf32
from ..ops.conv3x3 import conv3x3_bn_act, fold_bn
from .layers import max_pool_2x2, upsample_nearest_2x

BN_EPS = 1e-5  # the TrackNet BatchNorm's (torch's default)

#: ConvBNs of each stack.
_CONVS = {"down_block_1": 2, "down_block_2": 2, "down_block_3": 3, "bottleneck": 3,
          "up_block_1": 3, "up_block_2": 2, "up_block_3": 2}


class FastTrackNet:
    """TrackNet's forward over a Flax variables tree, inference only."""

    def __init__(self, out_dim: int = 8, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda"):
        self.out_dim = out_dim
        self.dtype = dtype
        self.device = torch.device(device)

    def _tensor(self, value, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device, dtype)
        return torch.tensor(np.asarray(value), dtype=dtype, device=self.device)

    def _stack(self, variables: Mapping[str, Any], name: str, x: torch.Tensor):
        params = variables["params"][name]
        stats = variables["batch_stats"][name]
        for i in range(1, _CONVS[name] + 1):
            conv = params[f"conv_{i}"]
            bn, bn_stats = conv["bn"], stats[f"conv_{i}"]["bn"]
            scale, bias = fold_bn(self._tensor(bn["scale"]), self._tensor(bn["bias"]),
                                  self._tensor(bn_stats["mean"]), self._tensor(bn_stats["var"]),
                                  BN_EPS)
            kernel = self._tensor(conv["conv"]["kernel"]).to(self.dtype)  # HWIO
            x = conv3x3_bn_act(x, kernel, scale, bias, act="relu")
        return x

    def apply(self, variables: Mapping[str, Any], x, train: bool = False) -> torch.Tensor:
        """(N, H, W, in_dim) windows (a tensor or an array; moved to the
        device) -> (N, H, W, out_dim) fp32 heatmaps."""
        if train:
            raise ValueError("FastTrackNet is inference-only (train=True)")
        v = variables
        x1 = self._stack(v, "down_block_1", self._tensor(x, self.dtype))
        x2 = self._stack(v, "down_block_2", max_pool_2x2(x1))
        x3 = self._stack(v, "down_block_3", max_pool_2x2(x2))
        x = self._stack(v, "bottleneck", max_pool_2x2(x3))
        x = self._stack(v, "up_block_1", torch.cat([upsample_nearest_2x(x), x3], dim=-1))
        x = self._stack(v, "up_block_2", torch.cat([upsample_nearest_2x(x), x2], dim=-1))
        x = self._stack(v, "up_block_3", torch.cat([upsample_nearest_2x(x), x1], dim=-1))
        pred = variables["params"]["predictor"]
        kernel = self._tensor(pred["kernel"]).to(self.dtype).float()  # (1, 1, 64, out_dim)
        with no_tf32():
            y = F.conv2d(x.float().permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1))
        y = y.permute(0, 2, 3, 1) + self._tensor(pred["bias"])
        return torch.sigmoid(y)
