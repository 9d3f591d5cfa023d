"""Plain preprocessing of the reference pipeline, frozen copies of the
semantics the reference repository's users get from OpenCV and Pillow:

- the I420 round trip of the port's default wire format (OpenCV's integer
  BT.601, shift 20; chroma of each 2x2 block's top-left pixel, nearest
  upsampling, luma floored at 16);
- Pillow's convolution resampling (antialiased, coefficients on its 2^-22
  grid, the uint8 clip between the two passes) and OpenCV's INTER_LINEAR,
  each as a dense (dst, src) matrix applied in float32 with TF32 off;
- ultralytics' letterbox (stride-aligned canvas, padding 114);
- the median background (numpy's even-count median, truncated to uint8).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SHIFT, _ROUND = 20, 1 << 19
_CY, _CVR, _CVG, _CUG, _CUB = 1220542, 1673527, -852492, -409993, 2116026
_Y = (269484, 528482, 102760)
_U = (-155188, -305135, 460324)
_V = (460324, -385875, -74448)


def i420_round_trip(rgb: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> the RGB that an I420 encode and decode
    (cv2.COLOR_RGB2YUV_I420, then COLOR_YUV2RGB_I420) give, uint8."""
    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    def weighted(c, r, g, b, offset):
        return (c[0] * r + c[1] * g + c[2] * b + _ROUND + (offset << _SHIFT)) >> _SHIFT

    y = weighted(_Y, r, g, b, 16)
    rs, gs, bs = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    u = weighted(_U, rs, gs, bs, 128) - 128
    v = weighted(_V, rs, gs, bs, 128) - 128
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2)
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
    yy = _CY * torch.clamp(y - 16, min=0) + _ROUND
    out = torch.stack([(yy + _CVR * v) >> _SHIFT, (yy + _CVG * v + _CUG * u) >> _SHIFT,
                       (yy + _CUB * u) >> _SHIFT], dim=-1)
    return out.clamp(0, 255).to(torch.uint8)


def _pil_filter(name: str):
    if name == "bilinear":
        return (lambda x: np.where(np.abs(x) < 1.0, 1.0 - np.abs(x), 0.0)), 1.0
    a = -0.5

    def bicubic(x):
        x = np.abs(x)
        return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))

    return bicubic, 2.0


def pil_matrix(src: int, dst: int, name: str = "bicubic") -> np.ndarray:
    """Pillow's 1-D resampling pass (Resample.c precompute_coeffs) as a
    (dst, src) matrix, antialias and fixed-point rounding included."""
    f, support = _pil_filter(name)
    scale = src / dst
    fscale = max(scale, 1.0)
    support *= fscale
    one = 1 << 22
    rows = np.zeros((dst, src), np.float64)
    for i in range(dst):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), src)
        xs = np.arange(lo, hi)
        w = f((xs + 0.5 - center) / fscale)
        if w.sum() != 0:
            w = w / w.sum()
        rows[i, lo:hi] = np.where(w < 0, np.ceil(w * one - 0.5), np.floor(w * one + 0.5)) / one
    return rows


def cv2_linear_matrix(src: int, dst: int) -> np.ndarray:
    """cv2.resize INTER_LINEAR's pass (half-pixel centres, clamped edges)."""
    rows = np.zeros((dst, src), np.float64)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = math.floor(x)
        frac = x - x0
        rows[i, min(max(x0, 0), src - 1)] += 1.0 - frac
        rows[i, min(max(x0 + 1, 0), src - 1)] += frac
    return rows.astype(np.float32)


class Resize:
    """A separable resize of (B, H, W, C) float32 stacks on one device."""

    def __init__(self, src_hw, dst_hw, method: str, device):
        if method == "cv2_linear":
            mh, mw, self.quantize = (cv2_linear_matrix(src_hw[0], dst_hw[0]),
                                     cv2_linear_matrix(src_hw[1], dst_hw[1]), False)
        else:
            name = method.split("_", 1)[1]
            mh, mw, self.quantize = (pil_matrix(src_hw[0], dst_hw[0], name),
                                     pil_matrix(src_hw[1], dst_hw[1], name), True)
        self.mh = torch.as_tensor(mh, dtype=torch.float32, device=device)
        self.mw = torch.as_tensor(mw, dtype=torch.float32, device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.einsum("bhwc,pw->bhpc", x.float(), self.mw)
        if self.quantize:
            x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
        return torch.einsum("bhwc,oh->bowc", x, self.mh)


class Letterbox:
    """ultralytics LetterBox(auto=True, stride=32) with cv2 INTER_LINEAR."""

    def __init__(self, src_hw, imgsz: int, device):
        h, w = src_hw
        r = min(imgsz / h, imgsz / w)
        nw, nh = round(w * r), round(h * r)
        ow, oh = math.ceil(nw / 32) * 32, math.ceil(nh / 32) * 32
        self.left, self.top = int(round((ow - nw) / 2 - 0.1)), int(round((oh - nh) / 2 - 0.1))
        self.right, self.bottom = ow - nw - self.left, oh - nh - self.top
        self.gain = r
        self.resize = Resize(src_hw, (nh, nw), "cv2_linear", device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self.resize(x)
        return torch.nn.functional.pad(y, (0, 0, self.left, self.right, self.top, self.bottom),
                                       value=114.0)

    def to_source(self, xy: torch.Tensor) -> torch.Tensor:
        """(..., 2k) x, y, x, y ... in letterbox pixels -> source pixels."""
        pad = torch.tensor([self.left, self.top], dtype=xy.dtype, device=xy.device)
        return ((xy.reshape(*xy.shape[:-1], -1, 2) - pad) / self.gain).reshape(xy.shape)


def median_uint8(frames: torch.Tensor) -> torch.Tensor:
    """np.median over axis 0 of a (N, H, W, 3) uint8 stack, truncated to
    uint8 (the reference's `median.astype('uint8')`), computed in row
    blocks on the stack's device."""
    n, h = frames.shape[:2]
    out = torch.empty(frames.shape[1:], dtype=torch.uint8, device=frames.device)
    for r in range(0, h, 64):
        s = torch.sort(frames[:, r: r + 64], dim=0).values.to(torch.int32)
        twice = s[n // 2] * 2 if n % 2 else s[n // 2 - 1] + s[n // 2]
        out[r: r + 64] = (twice // 2).to(torch.uint8)
    return out
