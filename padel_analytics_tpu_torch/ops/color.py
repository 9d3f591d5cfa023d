"""The I420 (YUV 4:2:0) wire format, bit-exact to OpenCV both ways.

Counterpart of ``padel_analytics_tpu/ops/color.py``. I420 costs 1.5 bytes a
pixel on the host->device link against RGB's 3: the fused pipeline packs
each frame as I420 on the host (`rgb_to_i420`, numpy: the port does not
depend on OpenCV) and rebuilds RGB on the device (`i420_to_rgb`, int32 torch
ops). The only loss against RGB ingest is the chroma subsampling.

Both use OpenCV's integer BT.601 (shift 20, round half up):

- RGB -> I420 (cv2.COLOR_RGB2YUV_I420): Y of every pixel; U and V of the
  top-left pixel of each 2x2 block.
- I420 -> RGB (cv2.COLOR_YUV2RGB_I420): luma floored at 16 before scaling,
  nearest 2x2 chroma upsampling.

The buffer of one (H, W) image is (H * 3 // 2, W) uint8: H rows of Y, then
the (H/2, W/2) U plane and the V plane, each contiguous (so for H not a
multiple of 4 a U row straddles two buffer rows).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

_SHIFT = 20
_ROUND = 1 << (_SHIFT - 1)
# I420 -> RGB (OpenCV's ITUR_BT_601_CY, CVR, CVG, CUG, CUB).
_CY = 1220542
_CVR = 1673527
_CVG = -852492
_CUG = -409993
_CUB = 2116026
# RGB -> I420 (OpenCV's ITUR_BT_601_CRY ... CBV; V's red weight is CBU).
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448


def _check_even(h: int, w: int) -> None:
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dimensions, got {h}x{w}")


def i420_to_rgb(buf: torch.Tensor, height: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., height * 3 // 2, W) uint8 I420 buffers -> (..., height, W, 3)
    RGB of exact uint8 values, in `dtype`, on the buffer's device."""
    h, w = height, buf.shape[-1]
    _check_even(h, w)
    if buf.shape[-2] != h * 3 // 2:
        raise ValueError(f"I420 buffer {tuple(buf.shape)} does not hold {h} rows")
    lead = tuple(buf.shape[:-2])
    y = buf[..., :h, :].to(torch.int32)
    # U fully precedes V in the chroma region; split by reshape, so heights
    # not divisible by 4 (U rows not aligned to buffer rows) work too.
    chroma = buf[..., h:, :].reshape(lead + (2, h // 2, w // 2))

    def up2(p):  # nearest 2x2 chroma upsample
        p = p.to(torch.int32) - 128
        return p.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    u, v = up2(chroma[..., 0, :, :]), up2(chroma[..., 1, :, :])
    yy = _CY * torch.clamp(y - 16, min=0) + _ROUND
    r = (yy + _CVR * v) >> _SHIFT
    g = (yy + _CVG * v + _CUG * u) >> _SHIFT
    b = (yy + _CUB * u) >> _SHIFT
    return torch.stack([r, g, b], dim=-1).clamp_(0, 255).to(dtype)


def rgb_to_i420(rgb: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """One (H, W, 3) uint8 RGB frame -> its (H * 3 // 2, W) uint8 I420
    buffer, equal to cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420). Writes into
    `out` when given (a pinned staging slot, say). Thread-safe: each thread
    keeps its own scratch planes."""
    h, w, _ = rgb.shape
    _check_even(h, w)
    planes = _scratch(h, w)[0]
    # Planes first: products over contiguous planes run ~3x faster than over
    # the interleaved channels.
    np.copyto(planes, rgb.transpose(2, 0, 1))
    return planes_to_i420(planes, out)


def planes_to_i420(planes: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """`rgb_to_i420` of a frame given as its (3, H, W) uint8 R, G and B
    planes."""
    _, h, w = planes.shape
    _check_even(h, w)
    if out is None:
        out = np.empty((h * 3 // 2, w), np.uint8)
    _, acc, tmp, cacc, ctmp = _scratch(h, w)
    r, g, b = planes
    # Every sum stays inside int32 and lands in [16, 240] after the shift,
    # so no clamp is needed (OpenCV's saturate_cast never bites).
    _weighted(r, g, b, (_CRY, _CGY, _CBY), 16, acc, tmp)
    np.copyto(out[:h], acc, casting="unsafe")
    chroma = out[h:].reshape(2, h // 2, w // 2)
    r, g, b = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    for plane, coefs in zip(chroma, ((_CRU, _CGU, _CBU), (_CBU, _CGV, _CBV))):
        _weighted(r, g, b, coefs, 128, cacc, ctmp)
        np.copyto(plane, cacc, casting="unsafe")
    return out


def _weighted(r, g, b, coefs, offset: int, acc: np.ndarray, tmp: np.ndarray) -> None:
    """acc = (cr * r + cg * g + cb * b + 2^19 + offset * 2^20) >> 20, in int32."""
    cr, cg, cb = coefs
    np.multiply(r, cr, out=acc, dtype=np.int32)
    np.multiply(g, cg, out=tmp, dtype=np.int32)
    acc += tmp
    np.multiply(b, cb, out=tmp, dtype=np.int32)
    acc += tmp
    acc += _ROUND + (offset << _SHIFT)
    acc >>= _SHIFT


_local = threading.local()


def _scratch(h: int, w: int):
    """This thread's scratch arrays for (h, w) frames, reused across calls:
    fresh 8 MB arrays a 1080p frame would cost their page faults each time."""
    cached = getattr(_local, "scratch", None)
    if cached is None or cached[0] != (h, w):
        cached = ((h, w), (np.empty((3, h, w), np.uint8),
                           np.empty((h, w), np.int32), np.empty((h, w), np.int32),
                           np.empty((h // 2, w // 2), np.int32),
                           np.empty((h // 2, w // 2), np.int32)))
        _local.scratch = cached
    return cached[1]
