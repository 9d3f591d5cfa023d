"""OpenCV's INTER_AREA downscale, bit-exact, in numpy on the host.

Counterpart of the ``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)``
calls of the JAX package's 'derived' ingest: each frame before its I420 pack
(``padel_analytics_tpu/trackers/fused.py`` `_pack_chunk`) and the float32
median of the subtract background modes (`_gather_setup`). The port does not
depend on OpenCV, so it keeps its own copy of the two paths OpenCV takes for
a downscale (``resize`` in OpenCV's imgproc, read off its behaviour: the
tests hold every case against the installed cv2):

- integer factors on both axes (1920x1080 -> 960x540 is 2x2): the area's
  pixels summed and scaled. uint8 at 2x2 rounds half up,
  ``(a + b + c + d + 2) >> 2``; other integer areas take the int sum times
  the float32 reciprocal of the area, rounded half to even; float32 sums in
  float32 in the area's row-major order, four at a time, and scales by the
  reciprocal;
- other factors (1280x720 -> 960x540 is x0.75): per axis a table of
  (destination, source, weight) taps, each source pixel weighted by the
  share of it that the destination cell covers (computed in float64, stored
  as float32), accumulated in float32, first along each source row, then
  across rows; uint8 rounds half to even at the end.

Enlarging an axis is a different OpenCV path (a bilinear variant) and is
refused. The factor test and every weight are computed in float64 as OpenCV
computes them.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Optional

import numpy as np

_DBL_EPSILON = float(np.finfo(np.float64).eps)


def _scales(src_hw: tuple[int, int], dst_hw: tuple[int, int]) -> tuple[float, float]:
    """(scale_y, scale_x) as OpenCV derives them: 1 / (dst / src), float64."""
    return tuple(1.0 / (d / s) for s, d in zip(src_hw, dst_hw))


def _integer_factor(scale: float) -> Optional[int]:
    """The integer a scale rounds to, where it is one within DBL_EPSILON."""
    k = round(scale)  # OpenCV's saturate_cast<int>: round half to even
    return k if abs(scale - k) < _DBL_EPSILON else None


@functools.lru_cache(maxsize=32)
def _area_taps(src: int, dst: int, scale: float) -> tuple[np.ndarray, np.ndarray]:
    """One axis's taps for a non-integer factor: (dst, T) source indices and
    float32 weights, each destination's taps in OpenCV's order (the partial
    pixel before the cell, the whole pixels, the partial pixel after it),
    padded with weight 0 (an exact no-op in the float32 sums)."""
    taps: list[list[tuple[int, np.float32]]] = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            row.append((sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        taps.append(row)
    t = max(map(len, taps))
    index = np.zeros((dst, t), np.intp)
    weight = np.zeros((dst, t), np.float32)
    for dx, row in enumerate(taps):
        for j, (sx, a) in enumerate(row):
            index[dx, j], weight[dx, j] = sx, a
    return index, weight


def _fast(img: np.ndarray, ky: int, kx: int) -> np.ndarray:
    """Integer factors: every destination pixel is the mean of a ky x kx block."""
    h, w = img.shape[0] // ky, img.shape[1] // kx
    if (h * ky, w * kx) != img.shape[:2]:
        raise ValueError(f"{img.shape[:2]} is not a multiple of the factors {(ky, kx)}")
    blocks = [img[sy::ky, sx::kx] for sy in range(ky) for sx in range(kx)]  # row-major
    if img.dtype == np.uint8:
        total = np.zeros(blocks[0].shape, np.int32)
        for b in blocks:
            total += b
        if (ky, kx) == (2, 2) and (img.ndim == 2 or img.shape[2] in (1, 3, 4)):
            return ((total + 2) >> 2).astype(np.uint8)
        scaled = total.astype(np.float32) * np.float32(1.0 / (ky * kx))
        return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)
    if (ky, kx) == (2, 2) and img.shape[2:] != (3,):
        # OpenCV vectorises 1 and 4 channels at 2x2 with another summation
        # order, which its scalar tail does not share.
        raise NotImplementedError("float32 INTER_AREA at 2x2 takes 3 channels here")
    # float32: the sum starts at 0 and takes the blocks four at a time.
    total = np.zeros(blocks[0].shape, np.float32)
    k = 0
    while k + 4 <= len(blocks):
        total += ((blocks[k] + blocks[k + 1]) + blocks[k + 2]) + blocks[k + 3]
        k += 4
    for b in blocks[k:]:
        total += b
    return total * np.float32(1.0 / (ky * kx))


_local = threading.local()


def _halve_rgb_planes(img: np.ndarray) -> np.ndarray:
    """The uint8 2x2 case of 3 channels, (H, W, 3) -> (3, H/2, W/2) planes:
    the two rows of each block added first (contiguous rows), then the two
    columns with the channel axis outermost, so numpy's inner loops run
    along the long axis. Returns this thread's scratch planes."""
    h, w = img.shape[0] // 2, img.shape[1] // 2
    cached = getattr(_local, "halve", None)
    if cached is None or cached[0] != (h, w):
        cached = ((h, w), np.empty((h, w, 6), np.uint16), np.empty((h, 3, w), np.uint16),
                  np.empty((3, h, w), np.uint8))
        _local.halve = cached
    _, rows, cols, planes = cached
    pairs = img.reshape(h, 2, w, 6)
    np.add(pairs[:, 0], pairs[:, 1], out=rows, dtype=np.uint16)
    np.add(rows[..., :3].transpose(0, 2, 1), rows[..., 3:].transpose(0, 2, 1), out=cols)
    cols += 2
    cols >>= 2
    np.copyto(planes, cols.transpose(1, 0, 2), casting="unsafe")
    return planes


def _general(img: np.ndarray, dst_hw: tuple[int, int], scales) -> np.ndarray:
    """Non-integer factors: the horizontal taps on every source row, then
    the vertical taps across rows, both accumulated in float32."""
    (sh, sw), (dh, dw) = img.shape[:2], dst_hw
    xi, xa = _area_taps(sw, dw, scales[1])
    yi, ya = _area_taps(sh, dh, scales[0])
    src = img.astype(np.float32, copy=False)
    rows = np.zeros((sh, dw) + img.shape[2:], np.float32)
    wx = xa.reshape((1, dw, -1) + (1,) * (img.ndim - 2))
    for j in range(xi.shape[1]):
        rows += src[:, xi[:, j]] * wx[:, :, j]
    out = np.zeros((dh, dw) + img.shape[2:], np.float32)
    wy = ya.reshape((dh, -1) + (1,) * (img.ndim - 1))
    for j in range(yi.shape[1]):
        out += wy[:, j] * rows[yi[:, j]]
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def _factors(src_hw, dst_hw) -> tuple[Optional[int], Optional[int]]:
    """(ky, kx): each axis's integer factor, or None where it is not one."""
    return tuple(_integer_factor(s) for s in _scales(src_hw, dst_hw))


def resize_area(img: np.ndarray, dst_hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (dst_w, dst_h), interpolation=cv2.INTER_AREA)`` of
    an (H, W) or (H, W, C) uint8 or float32 image to a size no larger on
    either axis. Thread-safe."""
    src_hw = tuple(img.shape[:2])
    dst_hw = tuple(int(d) for d in dst_hw)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_area takes uint8 or float32, got {img.dtype}")
    if min(dst_hw) < 1 or any(d > s for s, d in zip(src_hw, dst_hw)):
        raise ValueError(f"resize_area only shrinks: {src_hw} -> {dst_hw}")
    ky, kx = _factors(src_hw, dst_hw)
    if ky is None or kx is None:
        return _general(img, dst_hw, _scales(src_hw, dst_hw))
    return _fast(img, ky, kx)


def resize_area_planes(rgb: np.ndarray, dst_hw: tuple[int, int]) -> np.ndarray:
    """`resize_area` of an (H, W, 3) uint8 frame as (3, H', W') planes, the
    layout the I420 pack reads (`ops/color.py::planes_to_i420`). At 2x2 the
    planes come straight from the block sums, with no interleaved copy, and
    are this thread's scratch, valid until its next call."""
    if rgb.dtype != np.uint8 or rgb.shape[2:] != (3,):
        raise TypeError(f"resize_area_planes takes (H, W, 3) uint8, got {rgb.dtype} "
                        f"{rgb.shape}")
    if _factors(rgb.shape[:2], dst_hw) == (2, 2):
        return _halve_rgb_planes(rgb)
    return np.ascontiguousarray(resize_area(rgb, dst_hw).transpose(2, 0, 1))
