"""TrackNet input construction for all four background modes.

Counterpart of ``padel_analytics_tpu/trackers/_ballwindow.py``:

- ``''``            3 channels/frame: PIL-bicubic squash resize to model res.
- ``'subtract'``    1 channel/frame: sum over channels of |frame - median|
                    at SOURCE resolution, cast to uint8 (which wraps mod 256,
                    a reference quirk kept for parity), then resized.
- ``'subtract_concat'`` 4 channels/frame: the 3-channel resize plus the
                    1-channel difference image.
- ``'concat'``      3 channels/frame plus the uint8-cast resized median
                    prepended once per window.

Each frame is preprocessed once into its channel group; a window
concatenates the groups of its frames in order (median first for
'concat') and divides by 255.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.resize import resize_plan

_FRAME_CHANNELS = {"": 3, "subtract": 1, "subtract_concat": 4, "concat": 3}


def frame_channels(bg_mode: str) -> int:
    """Channels per preprocessed frame for a background mode."""
    return _FRAME_CHANNELS[bg_mode]


def window_in_dim(bg_mode: str, seq_len: int) -> int:
    """TrackNet's input channels for a window of `seq_len` frames (the
    reference's get_model): each frame's channel group, and the median's 3
    channels once for 'concat'. An unknown mode counts 3 a frame, as in the
    JAX package. `models.tracknet.make_tracknet` reads it from here."""
    return seq_len * _FRAME_CHANNELS.get(bg_mode, 3) + (3 if bg_mode == "concat" else 0)


def median_model_resolution(median: np.ndarray | torch.Tensor, height: int, width: int,
                            bg_mode: str, device: torch.device | str) -> torch.Tensor:
    """Median background at model resolution, a uint8 (H, W, 3) tensor on
    `device`, made there from the median (a tensor on the device, as the
    ball tracker keeps it, or a host array).

    'concat': PIL-parity bicubic resize of the uint8-cast median with
    Pillow's rounding (including the reference's float-median -> uint8
    pre-cast). Other modes get a zeros placeholder that is never read."""
    if bg_mode != "concat":
        return torch.zeros((height, width, 3), dtype=torch.uint8, device=device)
    plan = resize_plan(tuple(median.shape[:2]), (height, width), "pil_bicubic")
    med = torch.as_tensor(median, device=device).to(torch.uint8).to(torch.float32)
    return torch.clamp(torch.floor(plan.apply(med) + 0.5), 0, 255).to(torch.uint8)


def make_frame_preprocess(src_hw: tuple[int, int], dst_hw: tuple[int, int], bg_mode: str):
    """Build the per-frame preprocess for one background mode.

    Returns ``fn(frames, median_src=None, swap=None) -> (B, H, W, C_f)``
    fp32 holding exact PIL-uint8 values in [0, 255], on the frames' device:

    - frames: (B, Hs, Ws, 3) uint8/float source frames (RGB) tensor
    - median_src: (Hs, Ws, 3) fp32 exact median (may hold .5 values) —
      required for the subtract modes
    - swap: optional (B,) flags; frames with flag > 0 are channel-reversed
      BEFORE the difference/resize (the reference's median-buffer quirk)
    """
    plan = resize_plan(tuple(src_hw), tuple(dst_hw), "pil_bicubic")
    needs_rgb = bg_mode in ("", "concat", "subtract_concat")
    needs_diff = bg_mode in ("subtract", "subtract_concat")

    def pre(frames: torch.Tensor, median_src: Optional[torch.Tensor] = None,
            swap: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = frames.float()
        if swap is not None:
            x = torch.where(swap[:, None, None, None] > 0, x.flip(-1), x)
        outs = []
        if needs_rgb:
            outs.append(torch.clamp(torch.floor(plan.apply(x) + 0.5), 0, 255))
        if needs_diff:
            diff = torch.sum(torch.abs(x - median_src[None]), dim=-1)
            # .astype('uint8') of the float sum: truncate, then wrap mod 256.
            diff = torch.remainder(torch.floor(diff), 256.0)
            g = plan.apply(diff[..., None])
            outs.append(torch.clamp(torch.floor(g + 0.5), 0, 255))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    return pre


def assemble_windows(frames_ext: torch.Tensor, median_resized: Optional[torch.Tensor],
                     bg_mode: str, seq_len: int, batch: int) -> torch.Tensor:
    """(batch, H, W, in_dim) normalised windows; window w uses frames
    [w, w + seq_len) of frames_ext ((batch + seq_len - 1, H, W, C_f) fp32
    uint8-values). median_resized: (H, W, 3) uint8-valued, 'concat' only."""
    parts = [frames_ext[j: j + batch].float() for j in range(seq_len)]
    if bg_mode == "concat":
        med = median_resized.float()[None].expand((batch,) + tuple(median_resized.shape))
        parts = [med] + parts
    return torch.cat(parts, dim=-1) / 255.0
