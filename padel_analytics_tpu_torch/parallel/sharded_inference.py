"""Sliding-window TrackNet inference with the clip's frame axis split over
the mesh's ranks and a seq_len-1 halo exchanged between neighbours.

Counterpart of ``padel_analytics_tpu/parallel/sharded_inference.py``. Rank
r owns the `shard` = ceil(n / d) frames [r * shard, (r + 1) * shard) of the
zero-padded clip and computes the windows starting in them. Two inter-rank
dependencies, each one ring of point-to-point transfers over the mesh's
group (`Mesh.ring_shift`):

1. the frame halo: a window starting near the end of a shard needs the
   first seq_len-1 frames of the next shard (from the right-hand
   neighbour);
2. the prediction halo: a frame's overlap ensemble needs the seq_len-1
   windows before it, which may start on the previous shard (from the
   left-hand neighbour; rank 0's is zeros).

With one rank each halo is the rank's own (the ring is the identity): no
transfer. With stride == seq_len (the nonoverlap mode) every shard holds
whole disjoint windows: no halo, no ensemble. The decoded (x, y, visibility)
are all-gathered, so every rank returns the whole clip's.

A rank runs its windows in batches of `batch` (the fused chunk in
`FusedPipeline.run_mesh`, the tracker's batch in `BallTracker`), carrying
the last seq_len-1 window predictions from batch to batch: the ensemble's
products and their order (j = 0 .. L-1) are those of the whole-shard sum,
TrackNet sees the batch size that `FusedPipeline.run` gives it, and a long
clip's windows never sit on the device at once. The decode is kernel K2 on
a CUDA device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.ensemble import overlap_ensemble_coefficients
from ..ops.heatmap import decode_heatmaps
from .mesh import Mesh


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _padded_shard(frames: torch.Tensor, lo: int, hi: int, dev: torch.device) -> torch.Tensor:
    """Frames [lo, hi) of the clip on `dev`, zero past its end."""
    n = frames.shape[0]
    part = frames[min(lo, n): min(hi, n)].to(dev)
    if part.shape[0] == hi - lo:
        return part
    pad = part.new_zeros((hi - lo - part.shape[0],) + tuple(frames.shape[1:]))
    return torch.cat([part, pad], dim=0)


def _gathered(mesh: Mesh, cx, cy, vis, n: int):
    """The whole clip's (cx, cy, vis) int32 host arrays from every rank's
    shard."""
    out = mesh.all_gather(torch.stack([cx, cy, vis], dim=-1).to(torch.int32))
    out = out[:n].cpu().numpy()
    return out[:, 0], out[:, 1], out[:, 2]


def sharded_window_inference(apply_fn: Callable[[torch.Tensor], torch.Tensor], frames,
                             median, mesh: Mesh, seq_len: int = 8, eval_mode: str = "weight",
                             bg_mode: str = "concat", stride: int = 1,
                             batch: Optional[int] = None):
    """The TrackNet window / ensemble / decode pass over the whole clip with
    its frame axis split over `mesh`. Returns host (cx, cy, vis) int32
    arrays of length N, the same on every rank and equal to the
    single-device path's.

    apply_fn: (B, H, W, C_in) fp32 windows on the mesh's device -> (B, H, W,
    L) heatmaps. frames: (N, H, W, C_f) uint8 preprocessed frame channels
    (numpy or a tensor; each rank reads its shard and moves it to its
    device). median: (H, W, 3) uint8 resized median ('concat' only).
    batch: windows a TrackNet call (None: the whole shard at once)."""
    # Imported here: the trackers import this module.
    from ..trackers._ballwindow import assemble_windows

    frames = _as_tensor(frames)
    n = frames.shape[0]
    d, dev, l = mesh.size, mesh.device, seq_len
    if n < l:
        raise ValueError("clip shorter than seq_len")
    if stride not in (1, l):
        raise ValueError(f"stride must be 1 or seq_len, got {stride}")
    median_dev = _as_tensor(median).to(dev)
    if stride == l:
        return _nonoverlap(apply_fn, frames, median_dev, mesh, l, bg_mode, batch)

    shard = -(-n // d)
    if shard < l - 1:
        raise ValueError(f"frame shard ({shard}) smaller than the halo (seq_len-1={l - 1}); use "
                         "fewer ranks or a longer clip")
    batch = batch or shard
    lo = mesh.rank * shard
    coef = np.zeros((shard * d, l), np.float32)
    coef[:n] = overlap_ensemble_coefficients(n, l, eval_mode)
    coef = torch.from_numpy(coef[lo: lo + shard]).to(dev)
    local = _padded_shard(frames, lo, lo + shard, dev)
    # The frame halo: the right-hand neighbour's first L-1 frames.
    ext = torch.cat([local, mesh.ring_shift(local[: l - 1], step=-1)], dim=0)

    def ensemble(buf, rows: range):
        """The ensemble of the shard's frames `rows`; buf's row r holds the
        window starting at local frame rows.start - (L-1) + r."""
        c = coef[rows.start: rows.stop]
        b = len(rows)
        return sum(c[:, j, None, None] * buf[j: j + b, l - 1 - j] for j in range(l))

    # Windows in batches, carrying the last L-1 predictions. A frame's
    # ensemble needs the L-1 windows before it: the shard's first L-1 frames
    # wait for the left-hand neighbour's last windows (kept: `head`).
    carry = None
    head, out = [], []
    for s in range(0, shard, batch):
        b = min(batch, shard - s)
        x = assemble_windows(ext[s: s + b + l - 1], median_dev, bg_mode, l, b)
        y = apply_fn(x).permute(0, 3, 1, 2).float()  # (b, L, H, W)
        # Windows starting past the clip's last window are zeroed.
        starts = torch.arange(lo + s, lo + s + b, device=dev)
        y = torch.where((starts <= n - l)[:, None, None, None], y, 0.0)
        if s < l - 1:
            head.append(y)
        buf = y if carry is None else torch.cat([carry, y], dim=0)
        first = max(s, l - 1)  # the first frame whose windows are all here
        if first < s + b:
            held = buf.shape[0] - b  # carried rows: buf's row r is window s - held + r
            out.append(decode_heatmaps(ensemble(buf[first - (l - 1) - s + held:],
                                                range(first, s + b))))
        carry = buf[-(l - 1):]
    # The prediction halo: the left-hand neighbour's last L-1 windows; zeros
    # before the clip.
    left = mesh.ring_shift(carry, step=1)
    if mesh.rank == 0:
        left = torch.zeros_like(left)
    buf = torch.cat([left] + head, dim=0)[: 2 * (l - 1)]
    out.insert(0, decode_heatmaps(ensemble(buf, range(0, l - 1))))
    cx, cy, vis = (torch.cat(parts) for parts in zip(*out))
    return _gathered(mesh, cx, cy, vis, n)


def _nonoverlap(apply_fn, frames: torch.Tensor, median_dev: torch.Tensor, mesh: Mesh, l: int,
                bg_mode: str, batch: Optional[int]):
    """stride == seq_len: every rank owns whole disjoint windows, each run
    once; window i's output channel j is frame i * L + j's heatmap."""
    n = frames.shape[0]
    shard = -(-n // (l * mesh.size)) * l
    lo = mesh.rank * shard
    wins = -(-(batch or shard) // l)  # windows a call
    parts = []
    for s in range(lo, lo + shard, wins * l):
        fr = _padded_shard(frames, s, min(s + wins * l, lo + shard), mesh.device).float()
        nwin = fr.shape[0] // l
        fr = fr.reshape((nwin, l) + tuple(fr.shape[1:]))
        win = [fr[:, j] for j in range(l)]
        if bg_mode == "concat":
            win = [median_dev.float()[None].expand((nwin,) + tuple(median_dev.shape))] + win
        y = apply_fn(torch.cat(win, dim=-1) / 255.0)
        heat = y.permute(0, 3, 1, 2).float().reshape((nwin * l,) + tuple(y.shape[1:3]))
        parts.append(torch.stack(decode_heatmaps(heat), dim=-1))
    out = torch.cat(parts)
    return _gathered(mesh, out[:, 0], out[:, 1], out[:, 2], n)
