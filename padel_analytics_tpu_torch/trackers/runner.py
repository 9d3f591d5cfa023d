"""TrackingRunner: the per-tracker inference pass with a single decode.

Counterpart of ``padel_analytics_tpu/trackers/runner.py``. The video is
decoded once into a `FrameStore` (RAM up to a cap, re-decode beyond); each
tracker skips inference when its JSON cache already holds predictions,
otherwise runs `predict_and_update` over the store and saves its cache.
Per-tracker wall clock goes to `stage_times`.

Not ported yet: the draw / collect pass (it needs ProjectedCourt, the
homography and DataAnalytics) and the fused single-upload pipeline; asking
for either raises NotImplementedError.
"""

from __future__ import annotations

import timeit
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.video import VideoInfo, frame_generator
from .base import Tracker


class FrameStore:
    """Decode-once frame cache of RGB uint8 frames. Falls back to
    re-decoding when the clip exceeds `max_cached_frames`."""

    def __init__(self, video_path: str | Path, start: int = 0, stride: int = 1,
                 end: Optional[int] = None, max_cached_frames: int = 4000):
        self.video_path = video_path
        self.start = start
        self.stride = stride
        self.end = end
        self.max_cached_frames = max_cached_frames
        self._frames: Optional[list[np.ndarray]] = None

    def __iter__(self):
        if self._frames is not None:
            yield from self._frames
            return
        frames: Optional[list[np.ndarray]] = []
        for frame in frame_generator(self.video_path, start=self.start,
                                     stride=self.stride, end=self.end):
            if frames is not None:
                frames.append(frame)
                if len(frames) > self.max_cached_frames:
                    frames = None
            yield frame
        if frames is not None:
            self._frames = frames


class TrackingRunner:
    """Runs a sequence of trackers over a video."""

    def __init__(
        self,
        trackers: list[Tracker],
        video_path: str | Path,
        inference_path: str | Path,
        start: int = 0,
        end: Optional[int] = None,
        collect_data: bool = False,
        max_cached_frames: int = 4000,
        fused: bool = False,
        render: bool = True,
    ):
        if fused:
            raise NotImplementedError(
                "the fused pipeline is not ported yet (ROADMAP.md Queue 1: Fused pipeline)"
            )
        if render or collect_data:
            raise NotImplementedError(
                "the draw / collect pass is not ported yet (ROADMAP.md Queue 1: Draw / collect): "
                "pass render=False, collect_data=False"
            )
        self.video_path = video_path
        self.inference_path = inference_path
        self.start = start
        self.stride = 1
        self.end = end
        self.video_info = VideoInfo.from_video_path(video_path)
        if self.end is None:
            self.total_frames = self.video_info.total_frames
        else:
            self.total_frames = self.end - self.start
        self.frame_store = FrameStore(video_path, start, self.stride, end, max_cached_frames)
        self.trackers: dict[str, Tracker] = {
            str(t): t.video_info_post_init(self.video_info) for t in trackers
        }
        self.stage_times: dict[str, float] = {}

    def run(self) -> None:
        """Per-tracker inference, skipped where a cache was loaded."""
        print(f"runner: Running {self.total_frames} frames")
        for tracker in self.trackers.values():
            if len(tracker) != 0:
                print(f"{tracker}: {len(tracker)} predictions stored")
                continue
            t0 = timeit.default_timer()
            tracker.predict_and_update(iter(self.frame_store), total_frames=self.total_frames)
            t1 = timeit.default_timer()
            self.stage_times[str(tracker)] = t1 - t0
            print(f"{tracker}: {t1 - t0:.2f}s inference time.")
            tracker.save_predictions()
