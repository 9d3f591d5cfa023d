"""Fused stride-1 conv3x3 + folded BatchNorm + activation (kernel K1).

Counterpart of ``padel_analytics_tpu/ops/pallas_conv.py``: the same
function, NHWC with HWIO weights, symmetric (1, 1) padding, fp32 accumulation
and epilogue, one cast at the end. On a CUDA tensor it runs the hand-written
kernel in ``csrc/conv3x3_bn_act.cu`` (bf16 only); on a CPU tensor it runs
`conv3x3_bn_act_plain`, the plain PyTorch version the kernel is checked
against. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from ._fp32 import no_tf32

_ACTS = {"none": 0, "relu": 1, "silu": 2}

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
    """Input channels as the kernel takes them: a multiple of 8, so that a
    16-byte copy never straddles two taps."""
    return -(-cin // 8) * 8


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> the kernel's (9 * Cin_p, Cout) bf16 matrix,
    row k = (3 * dy + dx) * Cin_p + c, with zero rows for padded channels.
    Done once per weight (ConvBN caches it), not per call."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 HWIO kernel, got {tuple(w.shape)}")
    cp = padded_cin(cin)
    if cp != cin:
        w = F.pad(w, (0, 0, 0, cp - cin))
    return w.to(torch.bfloat16).reshape(9 * cp, cout).contiguous()


def conv3x3_bn_act(x, w, scale, bias, act: str = "silu") -> torch.Tensor:
    """Fused stride-1 conv3x3 + BN affine + activation; (B, H, W, Cout) in
    x's dtype. x: (B, H, W, Cin) NHWC; w: (3, 3, Cin, Cout) HWIO; scale,
    bias: (Cout,) fp32 (`fold_bn`)."""
    if x.device.type == "cpu":
        return conv3x3_bn_act_plain(x, w, scale, bias, act)
    return conv3x3_bn_act_packed(x, pack_weight(w), scale, bias, act)


def conv3x3_bn_act_packed(x, wk, scale, bias, act: str = "silu") -> torch.Tensor:
    """Launch kernel K1 on a CUDA tensor with a `pack_weight` matrix."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"kernel K1 takes CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"kernel K1 takes (B, H, W, C) bf16, got {x.dtype} {tuple(x.shape)}")
    b, h, w_, cin = x.shape
    cp = padded_cin(cin)
    cout = wk.shape[1]
    if wk.shape[0] != 9 * cp or wk.dtype != torch.bfloat16 or cout % 8:
        raise ValueError(
            f"packed weight {tuple(wk.shape)} {wk.dtype} does not fit Cin={cin} "
            "(Cout must be a multiple of 8)"
        )
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if scale.numel() != cout or bias.numel() != cout:
        raise ValueError(f"scale/bias must hold Cout={cout} values")
    if b * h * w_ >= 2**31:
        raise ValueError(f"B*H*W = {b * h * w_} exceeds the kernel's int32 pixel index")
    if cp != cin:
        x = F.pad(x, (0, cp - cin))
    tensors = [x.contiguous(), wk.contiguous(), scale.float().contiguous(),
               bias.float().contiguous()]
    for t in tensors:
        if t.device != x.device:
            raise ValueError("K1 inputs must share one device")
    x, wk, scale, bias = tensors
    out = torch.empty((b, h, w_, cout), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("conv3x3_bn_act")
    with torch.cuda.device(x.device):  # the launch targets the current device
        code = lib.conv3x3_bn_act_bf16(
            x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, w_, cp, cout, _ACTS[act], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "conv3x3_bn_act_bf16")
    launches += 1
    return out
