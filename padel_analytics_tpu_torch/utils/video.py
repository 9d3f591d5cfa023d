"""Host-side video input.

Counterpart of ``padel_analytics_tpu/utils/video.py`` (the decode side).
OpenCV is imported only where a video is opened, so the rest of the port
runs without it.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


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
    def from_video_path(cls, video_path: str | Path) -> "VideoInfo":
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
    video_path: str | Path,
    start: int = 0,
    stride: int = 1,
    end: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames (RGB at the decode boundary)."""
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
