"""Median-background estimation over a frame stack.

Counterpart of ``padel_analytics_tpu/ops/median.py``: the uint8 stack is
sorted along the frame axis in row chunks (bounding the sort's workspace)
and the two middle elements are combined with numpy's even-count semantics.
"""

from __future__ import annotations

import numpy as np
import torch


def _median_x2(stack: torch.Tensor) -> torch.Tensor:
    """Twice the median over axis 0 of a uint8 stack, as int32: doubling
    keeps np.median's k + 0.5 values exact in an integer."""
    n = stack.shape[0]
    s = torch.sort(stack, dim=0).values.to(torch.int32)
    if n % 2 == 1:
        return s[n // 2] * 2
    return s[n // 2 - 1] + s[n // 2]


def median_background(
    frames: np.ndarray,
    row_chunk: int = 32,
    exact: bool = False,
    *,
    device: torch.device | str,
) -> np.ndarray:
    """Median image of an (N, H, W, C) uint8 frame stack, computed on
    `device` in row chunks.

    exact=False: truncated uint8 (the reference's ``median.astype('uint8')``
    for bg_mode='concat'). exact=True: float32 with np.median semantics (can
    hold .5 values, what the reference keeps for the subtract modes)."""
    frames = np.asarray(frames)
    n, h, w, c = frames.shape
    out = np.empty((h, w, c), dtype=np.float32 if exact else np.uint8)
    for r0 in range(0, h, row_chunk):
        r1 = min(r0 + row_chunk, h)
        tile = torch.from_numpy(np.ascontiguousarray(frames[:, r0:r1])).to(device)
        x2 = _median_x2(tile).cpu().numpy()
        out[r0:r1] = (x2.astype(np.float32) / 2.0) if exact else (x2 // 2).astype(np.uint8)
    return out
