"""TrackingRunner: the inference pass with a single decode, fused or per
tracker.

Counterpart of ``padel_analytics_tpu/trackers/runner.py``. The video is
decoded once into a `FrameStore` (RAM up to a cap, re-decode beyond). With
`fused=True` and the players, pose and ball trackers (and optionally a
fixed court) present with empty caches, one `FusedPipeline` pass serves
them all (`stage_times["fused_inference"]`). Otherwise each tracker skips
inference when its JSON cache already holds predictions, else runs
`predict_and_update` over the store (`stage_times[name]`). Every tracker
that inferred saves its cache.

Not ported yet: the draw / collect pass (it needs ProjectedCourt, the
homography and DataAnalytics) and the streaming drawer; asking for either
raises NotImplementedError.
"""

from __future__ import annotations

import timeit
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.video import MemoryClip, VideoInfo, frame_generator
from .base import Tracker
from .fused import FusedPipeline


class FrameStore:
    """Decode-once frame cache of RGB uint8 frames. Falls back to
    re-decoding when the clip exceeds `max_cached_frames`."""

    def __init__(self, video_path: str | Path | MemoryClip, start: int = 0, stride: int = 1,
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
        video_path: str | Path | MemoryClip,
        inference_path: str | Path,
        start: int = 0,
        end: Optional[int] = None,
        collect_data: bool = False,
        max_cached_frames: int = 4000,
        fused: bool = False,
        fused_chunk: int = 16,
        # Wire format: 'rgb', or 'i420' (1.5 bytes a pixel, rebuilt on the
        # device bit-exactly to cv2; the only deviation from 'rgb' is the
        # chroma subsampling round trip).
        fused_ingest: str = "i420",
        # Only checked: 'auto' / 'host' (host ByteTrack at the drain) and
        # stride 1 (the reference's rolling ensemble) are the ported values.
        fused_association: str = "auto",
        fused_ball_stride: int = 1,
        fused_stream_draw: bool = False,
        render: bool = True,
    ):
        if render or collect_data:
            raise NotImplementedError(
                "the draw / collect pass is not ported yet (ROADMAP.md Queue 1: Draw / collect): "
                "pass render=False, collect_data=False"
            )
        if fused_stream_draw:
            raise NotImplementedError(
                "the streaming drawer is not ported yet (ROADMAP.md Queue 1 item 5)"
            )
        self.fused = fused
        self.fused_chunk = fused_chunk
        self.fused_ingest = fused_ingest
        if fused:
            # Refuse the fused options that are not ported here, before any
            # decode, rather than after the per-tracker set-up.
            FusedPipeline.check_options(fused_ingest, fused_association, fused_ball_stride)
        self.video_path = video_path
        self.inference_path = inference_path
        self.start = start
        self.stride = 1
        self.end = end
        self.video_info = VideoInfo.from_video_path(video_path)
        # Clamped to the clip: the fused loop trusts this count, and an `end`
        # past the clip would otherwise emit results for frames that do not
        # exist (the JAX runner's `end - start` is not clamped).
        clip_frames = self.video_info.total_frames
        last = clip_frames if end is None else min(end, clip_frames)
        self.total_frames = max(0, last - start)
        self.frame_store = FrameStore(video_path, start, self.stride, end, max_cached_frames)
        self.trackers: dict[str, Tracker] = {
            str(t): t.video_info_post_init(self.video_info) for t in trackers
        }
        self.stage_times: dict[str, float] = {}
        self._fused_pipeline: Optional[FusedPipeline] = None

    def restart(self) -> None:
        """Forget every tracker's results (the next run infers again)."""
        for tracker in self.trackers.values():
            tracker.restart()

    def run(self) -> None:
        """Inference: the fused pipeline when asked for and the trackers fit
        it, else per tracker; each tracker skipped where a cache was loaded."""
        print(f"runner: Running {self.total_frames} frames")
        if self.fused and self._try_fused_run():
            return
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

    def _try_fused_run(self) -> bool:
        """Run players + pose + ball (+ fixed court) in the single-upload
        fused pipeline. Returns False, for the per-tracker path, when the
        tracker set does not fit it, when any of the three already holds
        cached results, or when the clip is shorter than a TrackNet window
        (the per-tracker path zero-fills those, as the reference does)."""
        by_name = self.trackers
        needed = ("players_tracker", "players_keypoints_tracker", "ball_tracker")
        if not all(name in by_name for name in needed):
            return False
        if any(len(by_name[name]) != 0 for name in needed):
            return False
        # A court tracker with cached predictions keeps them.
        court = by_name.get("keypoints_tracker")
        if court is not None and len(court) != 0:
            court = None
        if self.total_frames < by_name["ball_tracker"].tracknet_seq_len:
            return False

        t0 = timeit.default_timer()
        # The cached pipeline is keyed to the court argument: a later run
        # whose court state differs (cache loaded vs empty) must rebuild.
        pipeline = self._fused_pipeline
        if pipeline is None or pipeline.court is not court:
            pipeline = self._fused_pipeline = FusedPipeline(
                by_name["players_tracker"], by_name["players_keypoints_tracker"],
                by_name["ball_tracker"], court, chunk=self.fused_chunk,
                ingest=self.fused_ingest,
            )
        out = pipeline.run(iter(self.frame_store), total_frames=self.total_frames)
        by_name["players_tracker"].results.load(out["players"])
        by_name["players_keypoints_tracker"].results.load(out["players_keypoints"])
        by_name["ball_tracker"].results.load(out["ball"])
        if court is not None:
            court.results.load(out["keypoints"])
        self.stage_times["fused_inference"] = timeit.default_timer() - t0
        print(f"runner: fused inference {self.stage_times['fused_inference']:.2f}s")
        for name in needed:
            by_name[name].save_predictions()
        if court is not None:
            court.save_predictions()
        return True
