"""Fused stride-1 conv3x3 + folded BatchNorm + activation (kernel K1).

Counterpart of ``padel_analytics_tpu/ops/pallas_conv.py``: the same
function, NHWC with HWIO weights, symmetric (1, 1) padding, fp32 accumulation
and epilogue, one cast at the end. On a CUDA tensor it runs the hand-written
kernel in ``csrc/conv3x3_bn_act.cu`` (bf16 only); on a CPU tensor it runs
`conv3x3_bn_act_plain`, the plain PyTorch version the kernel is checked
against. There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from ._fp32 import no_tf32

_ACTS = {"none": 0, "relu": 1, "silu": 2}
#: Codes at or above this are 100000 + the CUresult of a refused TMA tensor map.
_ENCODE_ERROR = 100000

#: Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "silu":
        return F.silu(y)
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act!r}")


def fold_bn(gamma, beta, mean, var, eps: float):
    """Fold inference-mode BatchNorm into ``y = conv * scale + bias``."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def conv3x3_bn_act_plain(x, w, scale, bias, act: str = "silu") -> torch.Tensor:
    """Plain PyTorch version: weights rounded to x's dtype, then conv, affine
    and activation in true fp32 (TF32 off), cast to x's dtype last."""
    with no_tf32():
        xf = x.float().permute(0, 3, 1, 2)
        wf = w.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(xf, wf, padding=1)
        y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
        y = _act(y, act)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def padded_cin(cin: int) -> int:
    """Input channels as the kernel takes them: a multiple of 8, so that
    every TMA stride is a multiple of 16 bytes."""
    return -(-cin // 8) * 8


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> the kernel's K-major (Cout, 9, Cin_p) bf16
    operand, ``wk[n, 3 * dy + dx, c] = w[dy, dx, c, n]``, zero for padded
    channels. Done once per weight (ConvBN caches it), not per call."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 HWIO kernel, got {tuple(w.shape)}")
    cp = padded_cin(cin)
    if cp != cin:
        w = F.pad(w, (0, 0, 0, cp - cin))
    return w.to(torch.bfloat16).reshape(9, cp, cout).permute(2, 0, 1).contiguous()


class TilePlan(NamedTuple):
    """One output tile of the kernel: th x tw pixels of one image by bn
    output channels."""
    th: int
    tw: int
    bn: int


#: Widths of the kernel's 128-pixel tiles (heights 2, 4, 8, 16).
TILE_WIDTHS = (64, 32, 16, 8)


def tile_plan(h: int, w: int, cout: int) -> TilePlan:
    """The kernel's tile for an (h, w) image and cout channels. Up to 64
    channels on images a multiple of 128 wide: 2 x 128 pixels (the kernel
    puts the pixels on the MMA's N side). Otherwise 128 pixels, of the width
    whose tiles cover the image with the fewest pixels (ties to the wider
    tile), by 128 output channels where Cout is a multiple of 128, else 64."""
    if cout <= 64 and w % 128 == 0:
        return TilePlan(2, 128, 64)

    def covered(tw: int) -> int:
        th = 128 // tw
        return -(-h // th) * th * (-(-w // tw) * tw)

    tw = min(TILE_WIDTHS, key=lambda t: (covered(t), -t))
    return TilePlan(128 // tw, tw, 128 if cout % 128 == 0 else 64)


def conv3x3_bn_act(x, w, scale, bias, act: str = "silu") -> torch.Tensor:
    """Fused stride-1 conv3x3 + BN affine + activation; (B, H, W, Cout) in
    x's dtype. x: (B, H, W, Cin) NHWC; w: (3, 3, Cin, Cout) HWIO; scale,
    bias: (Cout,) fp32 (`fold_bn`)."""
    if x.device.type == "cpu":
        return conv3x3_bn_act_plain(x, w, scale, bias, act)
    return conv3x3_bn_act_packed(x, pack_weight(w), scale, bias, act)


def conv3x3_bn_act_packed(x, wk, scale, bias, act: str = "silu") -> torch.Tensor:
    """Launch kernel K1 on a CUDA tensor with a `pack_weight` operand. The
    kernel takes Cout a multiple of 8 (16-byte TMA strides): another Cout
    (YOLOv8n-pose's 39-channel keypoint branch) runs with zero output
    channels appended to the weight, scale and bias, and the result is the
    view of the first Cout channels."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"kernel K1 takes CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"kernel K1 takes (B, H, W, C) bf16, got {x.dtype} {tuple(x.shape)}")
    b, h, w_, cin = x.shape
    cp = padded_cin(cin)
    cout = wk.shape[0]
    if wk.shape != (cout, 9, cp) or wk.dtype != torch.bfloat16:
        raise ValueError(
            f"packed weight {tuple(wk.shape)} {wk.dtype} does not fit Cin={cin} "
            "(want (Cout, 9, Cin_p) bf16)"
        )
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if scale.numel() != cout or bias.numel() != cout:
        raise ValueError(f"scale/bias must hold Cout={cout} values")
    if cp != cin:
        x = F.pad(x, (0, cp - cin))
    cout_k = padded_cin(cout)
    if cout_k != cout:
        wk = F.pad(wk, (0, 0, 0, 0, 0, cout_k - cout))
        scale, bias = (F.pad(t.float(), (0, cout_k - cout)) for t in (scale, bias))
    tensors = [x.contiguous(), wk.contiguous(), scale.float().contiguous(),
               bias.float().contiguous()]
    for t in tensors:
        if t.device != x.device:
            raise ValueError("K1 inputs must share one device")
        if t.data_ptr() % 16:
            raise ValueError("K1 inputs must be 16-byte aligned (TMA)")
    x, wk, scale, bias = tensors
    out = torch.empty((b, h, w_, cout_k), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out[..., :cout]
    plan = tile_plan(h, w_, cout_k)
    lib = _build.library("conv3x3_bn_act")
    with torch.cuda.device(x.device):  # the launch targets the current device
        code = lib.conv3x3_bn_act_bf16(
            x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, w_, cp, cout_k, _ACTS[act], plan.tw, plan.bn,
            torch.cuda.current_stream().cuda_stream,
        )
    if code >= _ENCODE_ERROR:
        raise RuntimeError(f"conv3x3_bn_act_bf16: tensor map refused (CUresult "
                           f"{code - _ENCODE_ERROR}) for x {tuple(x.shape)}, Cout {cout_k}")
    _build.check(code, "conv3x3_bn_act_bf16")
    launches += 1
    return out if cout_k == cout else out[..., :cout]
