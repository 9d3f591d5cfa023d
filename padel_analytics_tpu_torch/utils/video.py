"""Host-side video input.

Counterpart of ``padel_analytics_tpu/utils/video.py`` (the decode side).
OpenCV is imported only where a video file is opened, so the rest of the
port runs without it. A `MemoryClip` (decoded frames in memory) stands in
for a video path anywhere one is taken, for callers that decode elsewhere
or run where OpenCV is absent.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class MemoryClip:
    """A clip already decoded: RGB uint8 (H, W, 3) frames and their rate."""

    frames: Sequence[np.ndarray]
    fps: float


@dataclass(frozen=True)
class VideoInfo:
    """Source video metadata."""

    width: int
    height: int
    fps: float
    total_frames: int

    @property
    def resolution_wh(self) -> tuple[int, int]:
        return (self.width, self.height)

    @classmethod
    def from_video_path(cls, video_path: str | Path | MemoryClip) -> "VideoInfo":
        if isinstance(video_path, MemoryClip):
            h, w = video_path.frames[0].shape[:2]
            return cls(width=w, height=h, fps=float(video_path.fps),
                       total_frames=len(video_path.frames))
        import cv2

        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {video_path}")
        info = cls(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS)),
            total_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )
        cap.release()
        return info


def frame_generator(
    video_path: str | Path | MemoryClip,
    start: int = 0,
    stride: int = 1,
    end: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames (RGB at the decode boundary)."""
    if isinstance(video_path, MemoryClip):
        yield from video_path.frames[start:end:stride]
        return
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if start:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    index = start
    try:
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            if end is not None and index >= end:
                break
            if (index - start) % stride == 0:
                yield cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            index += 1
    finally:
        cap.release()
