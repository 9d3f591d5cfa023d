"""Image resampling as two matrix products (PIL-parity bicubic resize).

Counterpart of ``padel_analytics_tpu/ops/resize.py``. A resize from (H, W)
to (H', W') is ``out = R_h @ img @ R_w^T`` per channel, with R_h, R_w the
precomputed interpolation-weight matrices reproducing Pillow's convolution
resampling (antialias and edge renormalisation included, coefficients on
Pillow's 2^-22 fixed-point grid). Pillow quantises the intermediate image
to uint8 between the horizontal and the vertical pass; `ResizePlan.apply`
keeps that step, which byte-level parity needs.

`apply` runs both passes as dense fp32 matmuls with TF32 off: TF32 keeps
~10 mantissa bits and would move results by whole intensity steps. The
block-banded form of the JAX package is not ported yet.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ._fp32 import no_tf32


def _pil_filter(name: str):
    """Pillow filter kernels (Resample.c)."""
    if name == "bilinear":
        support = 1.0

        def f(x):
            x = np.abs(x)
            return np.where(x < 1.0, 1.0 - x, 0.0)

    elif name == "bicubic":
        support = 2.0
        a = -0.5

        def f(x):
            x = np.abs(x)
            return np.where(
                x < 1.0,
                ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0),
            )

    elif name == "nearest":
        support = 0.5

        def f(x):
            return np.where((x >= -0.5) & (x < 0.5), 1.0, 0.0)

    elif name == "lanczos":
        support = 3.0

        def f(x):
            x = np.asarray(x, dtype=np.float64)
            out = np.sinc(x) * np.sinc(x / 3.0)
            return np.where(np.abs(x) < 3.0, out, 0.0)

    else:
        raise ValueError(f"unknown PIL filter {name!r}")
    return f, support


# Pillow's PRECISION_BITS (Resample.c): coefficients on a 2^-22 grid, which
# float32 holds exactly.
_PIL_PRECISION_BITS = 32 - 8 - 2


def pil_resample_matrix(src: int, dst: int, filter: str = "bicubic") -> np.ndarray:
    """(dst, src) weight matrix reproducing Pillow's 1-D resampling pass
    (precompute_coeffs in Pillow's Resample.c), antialias included."""
    f, support = _pil_filter(filter)
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = support * filterscale

    rows = np.zeros((dst, src), dtype=np.float64)
    one = 1 << _PIL_PRECISION_BITS
    for i in range(dst):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src)
        xs = np.arange(xmin, xmax)
        w = f((xs + 0.5 - center) / filterscale)
        ssum = w.sum()
        if ssum != 0:
            w = w / ssum
        # normalize_coeffs_8bpc: round-half-away-from-zero to fixed point.
        w = np.where(w < 0, np.ceil(w * one - 0.5), np.floor(w * one + 0.5)) / one
        rows[i, xmin:xmax] = w
    return rows


@dataclass(frozen=True)
class ResizePlan:
    """Precomputed separable resize; `apply` runs as two matmuls."""

    r_h: np.ndarray  # (dst_h, src_h)
    r_w: np.ndarray  # (dst_w, src_w)

    def apply(self, images: torch.Tensor) -> torch.Tensor:
        """Resize a (..., H, W, C) stack to (..., H', W', C) fp32: the
        horizontal pass, Pillow's uint8 clip of the intermediate, then the
        vertical pass."""
        x = images.float()
        r_w = torch.as_tensor(self.r_w, dtype=torch.float32, device=x.device)
        r_h = torch.as_tensor(self.r_h, dtype=torch.float32, device=x.device)
        with no_tf32():
            x = torch.einsum("...hwc,pw->...hpc", x, r_w)
            # Pillow's clip8: round half up, clamp to uint8.
            x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
            return torch.einsum("...hwc,oh->...owc", x, r_h)


@functools.lru_cache(maxsize=64)
def resize_plan(
    src_hw: tuple[int, int],
    dst_hw: tuple[int, int],
    method: str = "pil_bicubic",
) -> ResizePlan:
    """Build (and cache) a Pillow-parity ResizePlan.

    method: 'pil_bicubic' | 'pil_bilinear' | 'pil_nearest' | 'pil_lanczos'
    """
    if not method.startswith("pil_"):
        raise ValueError(f"unknown resize method {method!r}")
    filt = method[len("pil_"):]
    (sh, sw), (dh, dw) = src_hw, dst_hw
    return ResizePlan(
        r_h=pil_resample_matrix(sh, dh, filt),
        r_w=pil_resample_matrix(sw, dw, filt),
    )
