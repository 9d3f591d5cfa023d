"""TrackNet, the ball-heatmap U-Net, channels-last.

Counterpart of ``padel_analytics_tpu/models/tracknet.py`` (TrackNet and
make_tracknet): down blocks 64/128/256, a 512 bottleneck, up blocks
256/128/64 over concat([up2x(low), skip]), a 1x1 predictor and a sigmoid.
Input (N, H, W, in_dim), output (N, H, W, out_dim) fp32 in [0, 1]. The 17
stride-1 3x3 ConvBNs run through kernel K1 on CUDA. Submodule names equal
the Flax tree's and the reference checkpoint's (``down_block_1.conv_1.conv``,
``...bn``, ``predictor``). InpaintNet and the subpixel up-block rewrite are
not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBN, max_pool_2x2, upsample_nearest_2x


class _ConvStack(nn.Module):
    """n x (Conv3x3 + BN + ReLU), submodules conv_1..conv_n."""

    def __init__(self, in_features: int, features: int, n: int):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"conv_{i + 1}", ConvBN(in_features if i == 0 else features, features))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"conv_{i + 1}")(x)
        return x


class _UpBlock(_ConvStack):
    """conv_1 over concat([up2x(x_low), skip]), then n-1 plain ConvBNs."""

    def forward(self, x_low, skip):
        return super().forward(torch.cat([upsample_nearest_2x(x_low), skip], dim=-1))


class TrackNet(nn.Module):
    """Heatmap U-Net over channel-stacked frame windows."""

    def __init__(self, in_dim: int, out_dim: int = 8):
        super().__init__()
        self.down_block_1 = _ConvStack(in_dim, 64, 2)
        self.down_block_2 = _ConvStack(64, 128, 2)
        self.down_block_3 = _ConvStack(128, 256, 3)
        self.bottleneck = _ConvStack(256, 512, 3)
        self.up_block_1 = _UpBlock(512 + 256, 256, 3)
        self.up_block_2 = _UpBlock(256 + 128, 128, 2)
        self.up_block_3 = _UpBlock(128 + 64, 64, 2)
        self.predictor = nn.Conv2d(64, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.down_block_1(x)
        x2 = self.down_block_2(max_pool_2x2(x1))
        x3 = self.down_block_3(max_pool_2x2(x2))
        x = self.bottleneck(max_pool_2x2(x3))
        x = self.up_block_1(x, x3)
        x = self.up_block_2(x, x2)
        x = self.up_block_3(x, x1)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.predictor.weight.to(x.dtype),
                     self.predictor.bias.to(x.dtype))
        return torch.sigmoid(y.float()).permute(0, 2, 3, 1)


def make_tracknet(seq_len: int = 8, bg_mode: str = "concat") -> tuple[TrackNet, int]:
    """Model + input channel count by background mode (the reference's
    get_model)."""
    if bg_mode == "subtract":
        in_dim = seq_len
    elif bg_mode == "subtract_concat":
        in_dim = seq_len * 4
    elif bg_mode == "concat":
        in_dim = (seq_len + 1) * 3
    else:
        in_dim = seq_len * 3
    return TrackNet(in_dim, seq_len), in_dim
