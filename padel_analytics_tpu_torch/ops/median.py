"""Median-background estimation over the head of a clip.

Counterpart of ``padel_analytics_tpu/ops/median.py``. The frames are never
stacked on the host: they go to the device band by band, a band being the
same rows of every frame. A few threads copy each frame's rows (one
contiguous block of an HWC frame) straight into a reused staging slot, which
is pinned for a CUDA device; the slot is uploaded asynchronously on a side
stream, and the band is sorted there along the frame axis, its two middle
elements combined with numpy's even-count semantics. The host fills the
next band's slot while the device uploads and sorts this one, and it waits
only for a slot's last upload before refilling it. The median stays on the
device (`median_on_device`); `median_background` downloads it.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

#: A staging slot holds at most this many bytes: the band height follows
#: from the number of frames and the frame's width.
BAND_BYTES = 64 << 20
#: Staging slots in turn: the host fills one while the device reads another.
SLOTS = 3
#: Threads that copy the frames' rows into a slot (numpy releases the
#: interpreter lock while it copies).
FILL_THREADS = 4


def _band_median(band: torch.Tensor, exact: bool) -> torch.Tensor:
    """The median over axis 0 of an (N, rows, W, C) uint8 band: truncated to
    uint8, or float32 with np.median's k + 0.5 values (exact). Only the two
    middle slices of the sort are widened; their sum is twice the median."""
    n = band.shape[0]
    s = torch.sort(band, dim=0).values
    x2 = s[(n - 1) // 2].to(torch.int16) + s[n // 2]
    return x2 / 2 if exact else (x2 // 2).to(torch.uint8)


def _fill_rows(dst: np.ndarray, frames, part: np.ndarray, r0: int, r1: int) -> None:
    """Copy rows [r0, r1) of the frames numbered in `part` into their places
    in the slot's band `dst`."""
    for j in part:
        np.copyto(dst[j], frames[j][r0:r1])


def median_on_device(frames: Sequence[np.ndarray], exact: bool = False, *,
                     device: torch.device | str, rows: Optional[int] = None) -> torch.Tensor:
    """Median image of N (H, W, C) uint8 frames (a list of frames, or an
    (N, H, W, C) stack; any strides), as an (H, W, C) tensor on `device`:
    uint8 truncated (the reference's ``median.astype('uint8')`` for
    bg_mode='concat') or, with `exact`, float32 with np.median's semantics
    (can hold .5 values, what the reference keeps for the subtract modes).

    rows: the band height; by default the most rows whose band of the N
    frames fits in BAND_BYTES."""
    n = len(frames)
    if n == 0:
        raise ValueError("the median needs at least one frame")
    first = np.asarray(frames[0])
    if first.dtype != np.uint8 or first.ndim != 3:
        raise ValueError(f"frames must be (H, W, C) uint8, got {first.dtype} {first.shape}")
    h, w, c = first.shape
    device = torch.device(device)
    cuda = device.type == "cuda"
    rows = min(h, rows or max(1, BAND_BYTES // (n * w * c)))
    out = torch.empty((h, w, c), dtype=torch.float32 if exact else torch.uint8, device=device)
    # Flat slots, so that the last band, if shorter, is a contiguous prefix.
    slots = [torch.empty(n * rows * w * c, dtype=torch.uint8, pin_memory=cuda)
             for _ in range(min(SLOTS, -(-h // rows)))]
    uploaded: list[Optional[torch.cuda.Event]] = [None] * len(slots)
    side = torch.cuda.Stream(device) if cuda else None
    if cuda:
        side.wait_stream(torch.cuda.current_stream(device))
    parts = np.array_split(np.arange(n), min(FILL_THREADS, n))

    with ThreadPoolExecutor(len(parts)) as pool:
        for b, r0 in enumerate(range(0, h, rows)):
            r1 = min(r0 + rows, h)
            i = b % len(slots)
            if uploaded[i] is not None:
                uploaded[i].synchronize()
            host = slots[i][: n * (r1 - r0) * w * c].view(n, r1 - r0, w, c)
            dst = host.numpy()
            for fill in [pool.submit(_fill_rows, dst, frames, part, r0, r1) for part in parts]:
                fill.result()
            with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                band = host.to(device, non_blocking=True)
                if cuda:
                    uploaded[i] = torch.cuda.Event()
                    uploaded[i].record(side)
                out[r0:r1] = _band_median(band, exact)
    if cuda:
        torch.cuda.current_stream(device).wait_stream(side)
    return out


def median_background(
    frames: np.ndarray,
    row_chunk: int = 32,
    exact: bool = False,
    *,
    device: torch.device | str,
) -> np.ndarray:
    """Median image of an (N, H, W, C) uint8 frame stack (or a list of
    frames), computed on `device` in bands of `row_chunk` rows
    (`median_on_device`) and returned as a numpy array.

    exact=False: truncated uint8 (the reference's ``median.astype('uint8')``
    for bg_mode='concat'). exact=True: float32 with np.median semantics (can
    hold .5 values, what the reference keeps for the subtract modes)."""
    return median_on_device(frames, exact, device=device, rows=row_chunk).cpu().numpy()
