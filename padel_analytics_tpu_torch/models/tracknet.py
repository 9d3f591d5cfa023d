"""TrackNet, the ball-heatmap U-Net, channels-last.

Counterpart of ``padel_analytics_tpu/models/tracknet.py`` (TrackNet and
make_tracknet): down blocks 64/128/256, a 512 bottleneck, up blocks
256/128/64 over concat([up2x(low), skip]), a 1x1 predictor and a sigmoid.
Input (N, H, W, in_dim), output (N, H, W, out_dim) fp32 in [0, 1]. The 17
stride-1 3x3 ConvBNs run through kernel K1 on CUDA. Submodule names equal
the Flax tree's and the reference checkpoint's (``down_block_1.conv_1.conv``,
``...bn``, ``predictor``). With ``subpixel_up`` each up block's first conv
runs the JAX package's exact low-resolution rewrite (`_SubpixelUpConvBN`),
whose skip half also goes through K1.

`InpaintNet` is the reference's 1-D conv U-Net over windows of ball
coordinates; it holds no 3x3 2-D conv and runs plain torch (``F.conv1d``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv3x3_bn_act_packed, conv3x3_bn_act_plain, pack_weight
from ..parallel.tensor_parallel import sharded_call
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


def _phase_kernels_2x2(k: torch.Tensor):
    """Collapse a (3, 3, Cin, Cout) HWIO kernel into the four 2x2 phase
    kernels equal to conv3x3(nearest_up2x(x)) at output phase (a, b): output
    row 2i+a reads source rows {i-1, i} (a = 0: taps [-1] | [0, +1]) or
    {i, i+1} (a = 1: taps [-1, 0] | [+1]); taps on one source pixel sum.
    The same for columns. Returns ((k00, k01), (k10, k11)), each (2, 2, Cin,
    Cout), summed in k's dtype."""
    r0 = torch.stack([k[0], k[1] + k[2]], dim=0)
    r1 = torch.stack([k[0] + k[1], k[2]], dim=0)

    def cols(kr):
        return (torch.stack([kr[:, 0], kr[:, 1] + kr[:, 2]], dim=1),
                torch.stack([kr[:, 0] + kr[:, 1], kr[:, 2]], dim=1))

    return cols(r0), cols(r1)


class _SubpixelUpConvBN(ConvBN):
    """An up block's first conv, conv3x3(concat([up2x(x_low), skip])) + BN
    + ReLU, without the upsample: the kernel splits along its input channels
    into an up part and a skip part. The up part runs as four 2x2 phase
    convs at low resolution (`_phase_kernels_2x2`: 16 taps an output pixel
    at a quarter of the pixels, against 36), the skip part as a stride-1 3x3
    conv with an identity epilogue (K1 on CUDA: scale 1, bias 0, no act);
    the two are added and BN + ReLU applied in fp32 with one cast, K1's
    epilogue order. The parameters are ConvBN's, under the same names
    (`conv`, `bn`), so checkpoints load unchanged.

    Counterpart of the JAX package's `_SubpixelUpConvBN`
    (``models/tracknet.py``), which rounds each conv's output to the compute
    dtype before the affine; here the sum and the affine stay in fp32."""

    def _operands(self, c_up: int, dtype: torch.dtype, on_cuda: bool):
        """(the four phase kernels OIHW in `dtype`, the skip part's kernel
        (HWIO fp32, or packed for K1 on CUDA), the folded scale and bias),
        cached until the parameters change, as ConvBN caches its own."""
        _, scale, bias, _ = self._folded(packed=False)
        key = (self._cache[0], c_up, dtype, on_cuda)
        if getattr(self, "_sub_cache", (None,))[0] != key:
            with torch.no_grad():
                k = self.conv.weight.float().permute(2, 3, 1, 0)  # HWIO
                # Tap sums in fp32, one cast after: a sum in bf16 would add
                # a rounding the materialised upsample never sees.
                phases = [p.to(dtype).permute(3, 2, 0, 1)
                          for pair in _phase_kernels_2x2(k[:, :, :c_up]) for p in pair]
                k_skip = k[:, :, c_up:]
                self._sub_cache = (key, phases, pack_weight(k_skip) if on_cuda else k_skip)
        return self._sub_cache[1], self._sub_cache[2], scale, bias

    def forward(self, x_low: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.training:
            # Training takes the dense upsample + conv, as the JAX package's.
            return super().forward(torch.cat([upsample_nearest_2x(x_low), skip], dim=-1))
        n, h, w, c_up = x_low.shape
        on_cuda = skip.device.type == "cuda"
        phases, k_skip, scale, bias = self._operands(c_up, x_low.dtype, on_cuda)
        xl = x_low.permute(0, 3, 1, 2)
        pads = ((1, 0), (0, 1))  # phase 0 reads {i-1, i}, phase 1 {i, i+1}
        # y_up[:, 2i + a, 2j + b] = phase (a, b) at (i, j), each phase written
        # into its strided slots as it is computed.
        y_up = x_low.new_empty((n, h, 2, w, 2, scale.numel()))
        for a in (0, 1):
            for b in (0, 1):
                ph = F.conv2d(F.pad(xl, pads[b] + pads[a]), phases[2 * a + b])
                y_up[:, :, a, :, b] = ph.permute(0, 2, 3, 1)
        ones = torch.ones_like(scale)
        zeros = torch.zeros_like(bias)
        if on_cuda:
            y_skip = conv3x3_bn_act_packed(skip, k_skip, ones, zeros, "none")
        else:
            y_skip = conv3x3_bn_act_plain(skip, k_skip, ones, zeros, "none")
        # (y_up + y_skip) * scale + bias, ReLU, in fp32 in place (one fp32
        # buffer at the output's size), then the one cast.
        y = y_up.reshape(n, 2 * h, 2 * w, -1).float()
        y.add_(y_skip).mul_(scale).add_(bias).relu_()
        return y.to(x_low.dtype)


class _UpBlock(_ConvStack):
    """conv_1 over concat([up2x(x_low), skip]), then n-1 plain ConvBNs; with
    `subpixel`, conv_1 is the exact low-resolution rewrite."""

    def __init__(self, in_features: int, features: int, n: int, subpixel: bool = False):
        super().__init__(in_features, features, n)
        if subpixel:
            self.conv_1 = _SubpixelUpConvBN(in_features, features)
        self.subpixel = subpixel

    def forward(self, x_low, skip):
        if not self.subpixel:
            return super().forward(torch.cat([upsample_nearest_2x(x_low), skip], dim=-1))
        x = self.conv_1(x_low, skip)
        for i in range(1, self.n):
            x = getattr(self, f"conv_{i + 1}")(x)
        return x


class TrackNet(nn.Module):
    """Heatmap U-Net over channel-stacked frame windows."""

    def __init__(self, in_dim: int, out_dim: int = 8, subpixel_up: bool = False):
        super().__init__()
        self.down_block_1 = _ConvStack(in_dim, 64, 2)
        self.down_block_2 = _ConvStack(64, 128, 2)
        self.down_block_3 = _ConvStack(128, 256, 3)
        self.bottleneck = _ConvStack(256, 512, 3)
        self.up_block_1 = _UpBlock(512 + 256, 256, 3, subpixel_up)
        self.up_block_2 = _UpBlock(256 + 128, 128, 2, subpixel_up)
        self.up_block_3 = _UpBlock(128 + 64, 64, 2, subpixel_up)
        self.predictor = nn.Conv2d(64, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.down_block_1(x)
        x2 = self.down_block_2(max_pool_2x2(x1))
        x3 = self.down_block_3(max_pool_2x2(x2))
        x = self.bottleneck(max_pool_2x2(x3))
        x = self.up_block_1(x, x3)
        x = self.up_block_2(x, x2)
        x = self.up_block_3(x, x1)
        y = sharded_call(self.predictor, x.permute(0, 3, 1, 2), F.conv2d, dim=1)
        return torch.sigmoid(y.float()).permute(0, 2, 3, 1)


def _conv1d(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """`conv` (k=3, padding 1, bias) over (N, C, L) in x's dtype; sharded
    over the mesh's 'model' axis where its weight is
    (parallel/tensor_parallel.py: the bias added after the gather)."""
    return sharded_call(conv, x, lambda x, w, b: F.conv1d(x, w, b, padding=1), dim=1)


class _Conv1DBlock(nn.Module):
    """Conv1d(k=3, padding 1, bias) + LeakyReLU(0.01) over (N, C, L)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Conv1d(in_features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(_conv1d(self.conv, x), 0.01)


class InpaintNet(nn.Module):
    """Coordinate inpainting net (the reference's InpaintNet). coords (N, L,
    2) normalised ball coordinates, mask (N, L, 1) (1 where the trajectory
    needs inpainting) -> (N, L, 2) fp32 in [0, 1]. Computes in the dtype of
    its input's cast (`dtype`). Submodule names are the Flax tree's; the
    reference checkpoint's `buttleneck.conv_{1,2}` load as `bottleneck_{1,2}`
    (`convert.convert_inpaintnet_checkpoint`)."""

    def __init__(self):
        super().__init__()
        self.down_1 = _Conv1DBlock(3, 32)
        self.down_2 = _Conv1DBlock(32, 64)
        self.down_3 = _Conv1DBlock(64, 128)
        self.bottleneck_1 = _Conv1DBlock(128, 256)
        self.bottleneck_2 = _Conv1DBlock(256, 256)
        self.up_1 = _Conv1DBlock(384, 128)
        self.up_2 = _Conv1DBlock(192, 64)
        self.up_3 = _Conv1DBlock(96, 32)
        self.predictor = nn.Conv1d(32, 2, 3, padding=1)

    def forward(self, coords: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = torch.cat([coords, mask], dim=-1).permute(0, 2, 1).to(dtype)  # (N, 3, L)
        x1 = self.down_1(x)
        x2 = self.down_2(x1)
        x3 = self.down_3(x2)
        x = self.bottleneck_2(self.bottleneck_1(x3))
        x = self.up_1(torch.cat([x, x3], dim=1))
        x = self.up_2(torch.cat([x, x2], dim=1))
        x = self.up_3(torch.cat([x, x1], dim=1))
        return torch.sigmoid(_conv1d(self.predictor, x).float()).permute(0, 2, 1)


def make_tracknet(seq_len: int = 8, bg_mode: str = "concat",
                  subpixel_up: bool = False) -> tuple[TrackNet, int]:
    """Model + input channel count by background mode (the reference's
    get_model); `subpixel_up` takes the exact low-resolution rewrite of the
    up blocks' first convs (the same parameters)."""
    if bg_mode == "subtract":
        in_dim = seq_len
    elif bg_mode == "subtract_concat":
        in_dim = seq_len * 4
    elif bg_mode == "concat":
        in_dim = (seq_len + 1) * 3
    else:
        in_dim = seq_len * 3
    return TrackNet(in_dim, seq_len, subpixel_up), in_dim
