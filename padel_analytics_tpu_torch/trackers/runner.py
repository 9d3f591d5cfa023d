"""TrackingRunner: the inference pass with a single decode, fused or per
tracker, then the draw / collect pass.

Counterpart of ``padel_analytics_tpu/trackers/runner.py``. The video is
decoded once into a `FrameStore` (RAM up to a cap, re-decode beyond). With
`fused=True` and the players, pose and ball trackers (and optionally a
court, fixed or from a model) present with empty caches, one
`FusedPipeline` pass serves them all (`stage_times["fused_inference"]`). Otherwise each tracker skips
inference when its JSON cache already holds predictions, else runs
`predict_and_update` over the store (`stage_times[name]`). Every tracker
that inferred saves its cache.

Then the draw / collect pass (`stage_times["draw_and_collect"]`): with
`render=True` each frame is decoded again, annotated (every tracker's
`draw`, the minimap, the projections; OpenCV) and encoded, and the player
projections feed `DataAnalytics` when `collect_data=True`; with
`render=False` the projections alone feed it, from the stored predictions,
with no decode and no OpenCV (`collect_data_only`); with neither, the pass
is skipped. Both give the same `data_analytics`. `fused_stream_draw=True` draws on a worker thread while
the fused pass runs (`_StreamingDrawer`), except with an InpaintNet, whose
pass needs the whole clip: the draw then follows the fused pass. A runner asked to render where
OpenCV is absent raises ImportError when it is constructed.

With a `mesh` (parallel/mesh.py: one process a device, every rank running
the same runner over the same clip) the fused pass is
`FusedPipeline.run_mesh` and every rank gets the same results and
data_analytics; only global rank 0 writes files (the prediction caches, the
video, data.csv through `write_csv`), the others collect without drawing. A
(data, model) mesh splits the frames over 'data' and runs replicated over
'model'.

Each `run()` opens one record of `core.profiling.tracer` (its spans
`runner.run`, `runner.fused`, `runner.<tracker>`, `runner.save`,
`runner.collect`, and `runner.write_csv` after it); `stage_times` is a view
of the last one.
"""

from __future__ import annotations

import threading
from copy import deepcopy
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.profiling import RunRecord, tracer
from ..utils.video import MemoryClip, VideoInfo, frame_generator, make_video_writer
from .base import Tracker
from .fused import FusedPipeline
from .objects import Ball, Keypoints, Players


def _require_cv2() -> None:
    """Raise an ImportError that says rendering needs OpenCV, where it is
    absent."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "render=True needs OpenCV (cv2), which is not installed here: pass render=False "
            "to collect data.csv without drawing"
        ) from e


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


class _StreamingDrawer:
    """The draw / collect pass on a worker thread, beside the fused pass.

    The fused drain appends finished frames to the trackers' results in
    frame order and calls notify(n_ready); the worker draws frame i once
    i < n_ready. It decodes the video with its own uncached FrameStore, so
    the two decodes never share state; OpenCV and numpy release the
    interpreter lock while they draw and encode."""

    def __init__(self, runner: "TrackingRunner"):
        self.runner = runner
        self._cond = threading.Condition()
        self._ready = 0
        self._done = False
        self.exc: Optional[BaseException] = None
        # Its span joins the runner's run.
        self._thread = threading.Thread(target=tracer.bind(self._run), daemon=True)
        self._thread.start()

    def notify(self, n_ready: int) -> None:
        with self._cond:
            if n_ready > self._ready:
                self._ready = n_ready
                self._cond.notify_all()

    def finish(self) -> None:
        """Signal the end of the results, join, re-raise the worker's error."""
        with self._cond:
            self._done = True
            self._cond.notify_all()
        self._thread.join()
        if self.exc is not None:
            raise self.exc

    def abort(self) -> None:
        """finish() for an error path: joins, and drops the worker's error
        (the caller's own is the one that surfaces)."""
        with self._cond:
            self._done = True
            self._cond.notify_all()
        self._thread.join()

    def _run(self) -> None:
        r = self.runner
        try:
            print(f"runner: Writing results into {r.inference_path} (streaming)")
            with tracer.span("runner.collect"):
                writer = r._open_writer()
                try:
                    store = FrameStore(r.video_path, r.start, r.stride, r.end,
                                       max_cached_frames=0)
                    for frame_index, frame in enumerate(store):
                        if frame_index >= r.total_frames:
                            break
                        with self._cond:
                            while self._ready <= frame_index and not self._done:
                                self._cond.wait()
                            if self._ready <= frame_index:
                                break  # done, and no result for this frame
                        r._draw_one(writer, frame_index, frame)
                except BaseException:
                    writer.release()  # finalise the container before the error surfaces
                    raise
                r._finish_draw(writer)
            print("runner: Done.")
        except BaseException as e:  # surfaced by finish()
            self.exc = e


class TrackingRunner:
    """Runs a sequence of trackers over a video, then draws and collects."""

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
        # > 0: this many chunks a dispatch (FusedPipeline.run_staged: one
        # upload and, on a card, one CUDA-graph replay a lane per round).
        fused_staged: int = 0,
        # Wire format: 'rgb', 'i420' (1.5 bytes a pixel, rebuilt on the
        # device bit-exactly to cv2; the only deviation from 'rgb' is the
        # chroma subsampling round trip), or 'derived' (I420 of the frame
        # downscaled on the host to a long side of at most
        # fused_wire_long_side; every model input derived on the device).
        fused_ingest: str = "i420",
        fused_wire_long_side: int = 960,
        # 'auto': host ByteTrack at the drain on one device, the association
        # scan under a mesh; 'host' / 'device' force either.
        fused_association: str = "auto",
        # 1: the reference's stride-1 rolling ensemble; the ball tracker's
        # seq_len: each window evaluated once (nonoverlap, an opt-in trade).
        fused_ball_stride: int = 1,
        # Draw on a worker thread while the fused pass runs (render only).
        fused_stream_draw: bool = False,
        # False: no decode, drawing or encode after inference; data.csv is
        # collected from the stored predictions alone.
        render: bool = True,
        # Encode the annotated video at this fraction of the source size
        # (drawn and collected at full size; data.csv is the same at any).
        render_scale: float = 1.0,
        # 'inline' encodes in this process, 'subprocess' in a child process
        # fed over a pipe (the same mp4v output).
        encoder: str = "inline",
        # A parallel.mesh.Mesh: the fused pass splits the clip's frames over
        # its ranks (FusedPipeline.run_mesh). None: one device.
        mesh=None,
    ):
        if render:
            _require_cv2()  # before any decode or inference
        if not 0.0 < render_scale <= 1.0:
            raise ValueError(f"render_scale must be in (0, 1], got {render_scale}")
        if fused_staged < 0:
            raise ValueError(f"fused_staged must be >= 0, got {fused_staged}")
        self.fused = fused
        self.fused_chunk = fused_chunk
        self.fused_staged = fused_staged
        self.fused_ingest = fused_ingest
        self.fused_wire_long_side = fused_wire_long_side
        self.fused_ball_stride = fused_ball_stride
        self.fused_association = fused_association
        self.mesh = mesh
        if fused:
            # Refuse the fused options that are unknown or not ported here,
            # before any decode, rather than after the per-tracker set-up.
            seq_lens = [t.tracknet_seq_len for t in trackers if str(t) == "ball_tracker"]
            FusedPipeline.check_options(fused_ingest, fused_association, fused_ball_stride,
                                        seq_lens[0] if seq_lens else None, fused_chunk)
        # With nothing to draw, the drawer stays off; under a mesh too (the
        # ball results come at the end of run_mesh).
        self.fused_stream_draw = fused_stream_draw and render and mesh is None
        self.render = render
        self.render_scale = float(render_scale)
        self.encoder = encoder
        self.video_path = video_path
        self.inference_path = inference_path
        self.start = start
        self.stride = 1
        self.end = end
        self.video_info = VideoInfo.from_video_path(video_path)
        # Clamped to the clip: an `end` past the clip would otherwise ask
        # for frames that do not exist (the JAX runner's `end - start` is
        # not clamped).
        clip_frames = self.video_info.total_frames
        last = clip_frames if end is None else min(end, clip_frames)
        self.total_frames = max(0, last - start)
        self.frame_store = FrameStore(video_path, start, self.stride, end, max_cached_frames)
        self.trackers: dict[str, Tracker] = {}
        self.is_fixed_keypoints = False
        for tracker in trackers:
            self.trackers[str(tracker)] = tracker.video_info_post_init(self.video_info)
            if tracker.object() == Keypoints:
                self.is_fixed_keypoints = (
                    getattr(tracker, "fixed_keypoints_detection", None) is not None)
        # Imported here: the analytics import this package's objects.
        from ..analytics import DataAnalytics, ProjectedCourt

        self.projected_court = ProjectedCourt(self.video_info)
        self.data_analytics = DataAnalytics() if collect_data else None
        self._record: Optional[RunRecord] = None  # the last run's
        self._fused_pipeline: Optional[FusedPipeline] = None
        self._fused_drew = False  # the last fused run drew as it went

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files: always on one
        device, the mesh's first process alone under a mesh (global rank 0:
        a (data, model) mesh runs replicated over 'model')."""
        return self.mesh is None or self.mesh.is_main

    @property
    def stage_times(self) -> dict[str, float]:
        """Seconds of the last run's stages, from its run record:
        'fused_inference' (`runner.fused`), each tracker's inference on the
        per-tracker path (`runner.<tracker>`) and 'draw_and_collect'
        (`runner.collect`); a stage the run skipped is absent."""
        out: dict[str, float] = {}
        if self._record is None:
            return out
        for span in self._record.spans:
            stage = span.name.removeprefix("runner.")
            if stage == "fused":
                stage = "fused_inference"
            elif stage == "collect":
                stage = "draw_and_collect"
            elif stage not in self.trackers:
                continue
            out[stage] = out.get(stage, 0.0) + span.seconds
        return out

    def write_csv(self, path: str | Path) -> None:
        """Write the collected data as the reference's data.csv (global rank
        0 only under a mesh)."""
        if self.is_writer:
            with tracer.span("runner.write_csv"):
                self.data_analytics.write_csv(path, self.video_info.fps)

    def _save(self, tracker: Tracker) -> None:
        if self.is_writer:
            with tracer.span("runner.save"):
                tracker.save_predictions()

    def restart(self) -> None:
        """Forget every tracker's results and the collected data (the next
        run infers and collects again)."""
        for tracker in self.trackers.values():
            tracker.restart()
        if self.data_analytics is not None:
            self.data_analytics.restart()

    def run(self) -> None:
        """Inference (the fused pipeline when asked for and the trackers fit
        it, else per tracker; each tracker skipped where a cache was
        loaded), then the draw / collect pass."""
        print(f"runner: Running {self.total_frames} frames")
        with tracer.run(self.total_frames) as self._record, tracer.span("runner.run"):
            if self.fused and self._try_fused_run():
                if not self._fused_drew:
                    self.draw_and_collect_data()
                return
            for tracker in self.trackers.values():
                if len(tracker) != 0:
                    print(f"{tracker}: {len(tracker)} predictions stored")
                    continue
                with tracer.span(f"runner.{tracker}") as span:
                    tracker.predict_and_update(iter(self.frame_store),
                                               total_frames=self.total_frames)
                print(f"{tracker}: {span.seconds:.2f}s inference time.")
                self._save(tracker)
            self.draw_and_collect_data()

    def _try_fused_run(self) -> bool:
        """Run players + pose + ball (+ court) in the single-upload
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

        with tracer.span("runner.fused") as span:
            self._fused_pass(court, needed)
        print(f"runner: fused inference {span.seconds:.2f}s")
        for name in needed:
            self._save(by_name[name])
        if court is not None:
            self._save(court)
        return True

    def _fused_pass(self, court: Optional[Tracker], needed: tuple[str, ...]) -> None:
        """The fused pipeline's pass, its results loaded into the trackers
        (and drawn as they come, with a streaming drawer)."""
        by_name = self.trackers
        # The cached pipeline is keyed to the court argument: a later run
        # whose court state differs (cache loaded vs empty) must rebuild.
        pipeline = self._fused_pipeline
        if pipeline is None or pipeline.court is not court:
            pipeline = self._fused_pipeline = FusedPipeline(
                by_name["players_tracker"], by_name["players_keypoints_tracker"],
                by_name["ball_tracker"], court, chunk=self.fused_chunk,
                ingest=self.fused_ingest, association=self.fused_association,
                wire_long_side=self.fused_wire_long_side, ball_stride=self.fused_ball_stride,
            )
        drawer, stream = None, None
        self._fused_drew = False
        # The inpaint pass finishes the ball results only at the end.
        if self.fused_stream_draw and by_name["ball_tracker"].inpaintnet is None:
            drawer = _StreamingDrawer(self)
            targets = [by_name[name].results.predictions for name in needed]
            if court is not None:
                targets.append(court.results.predictions)

            def stream(*new):
                for results, objs in zip(targets, new):
                    results += objs
                drawer.notify(len(targets[2]))

        try:
            if self.mesh is not None:  # a mesh takes precedence over staging
                out = pipeline.run_mesh(iter(self.frame_store), self.total_frames, self.mesh)
            elif self.fused_staged > 0:
                out = pipeline.run_staged(iter(self.frame_store), total_frames=self.total_frames,
                                          superchunk=self.fused_staged, stream=stream)
            else:
                out = pipeline.run(iter(self.frame_store), total_frames=self.total_frames,
                                   stream=stream)
        except BaseException:
            if drawer is not None:
                drawer.abort()
            raise
        by_name["players_tracker"].results.load(out["players"])
        by_name["players_keypoints_tracker"].results.load(out["players_keypoints"])
        by_name["ball_tracker"].results.load(out["ball"])
        if court is not None:
            court.results.load(out["keypoints"])
        if drawer is not None:
            drawer.finish()
            self._fused_drew = True

    # --- draw / collect ----------------------------------------------------

    @property
    def render_resolution_wh(self) -> tuple[int, int]:
        """The output video's size: the source's scaled by render_scale,
        rounded to even sizes."""
        w, h = self.video_info.resolution_wh
        if self.render_scale == 1.0:
            return (w, h)
        return (max(2, int(round(w * self.render_scale / 2)) * 2),
                max(2, int(round(h * self.render_scale / 2)) * 2))

    def _open_writer(self):
        return make_video_writer(self.inference_path, fps=float(self.video_info.fps),
                                 resolution_wh=self.render_resolution_wh, encoder=self.encoder)

    def _draw_one(self, writer, frame_index: int, frame: np.ndarray) -> None:
        """Draw and collect one frame (the body of the reference's draw
        loop), then write it."""
        import cv2

        # A copy: the store may serve its cache, which drawing must not
        # change (a later run would infer on annotated frames).
        frame_rgb = np.ascontiguousarray(frame).copy()
        cv2.putText(frame_rgb, f"Frame: {frame_index + 1}", (20, 50), cv2.FONT_HERSHEY_SIMPLEX,
                    1, (255, 255, 0), 1)
        players_detection = ball_detection = keypoints_detection = None
        for tracker in self.trackers.values():
            try:
                prediction = tracker.results[frame_index]
            except IndexError:
                print(f"runner: {tracker} missing frame {frame_index}")
                raise
            frame_rgb = prediction.draw(frame_rgb, **tracker.draw_kwargs())
            # Copies: the projections are written on them, and the stored
            # predictions stay as their caches hold them.
            if tracker.object() == Players:
                players_detection = deepcopy(prediction)
            elif tracker.object() == Ball:
                ball_detection = deepcopy(prediction)
            elif tracker.object() == Keypoints:
                keypoints_detection = deepcopy(prediction)
        output_frame, self.data_analytics = self.projected_court.draw_projections_and_collect_data(
            frame_rgb,
            keypoints_detection=keypoints_detection,
            players_detection=players_detection,
            ball_detection=ball_detection,
            data_analytics=self.data_analytics,
            is_fixed_keypoints=self.is_fixed_keypoints,
        )
        if self.data_analytics is not None:
            self.data_analytics.step(1)
        if self.render_scale != 1.0:
            output_frame = cv2.resize(output_frame, self.render_resolution_wh,
                                      interpolation=cv2.INTER_AREA)
        writer.write(output_frame)

    def _trim_trailing_frame(self) -> None:
        # The reference's loop leaves one extra frame entry at the end.
        if self.data_analytics is not None:
            self.data_analytics.frames = self.data_analytics.frames[:-1]

    def _finish_draw(self, writer) -> None:
        writer.release()
        self._trim_trailing_frame()

    def collect_data_only(self) -> None:
        """Collect without rendering: no decode, no OpenCV, no writer. The
        stored predictions go through the same projection path as the draw
        loop, so data_analytics is the same."""
        print("runner: Collecting data (render=False; no video output)")
        with tracer.span("runner.collect"):
            self._collect_frames()
        print("runner: Done.")

    def _collect_frames(self) -> None:
        """Every frame's stored predictions through the projections into
        data_analytics."""
        for name, tracker in self.trackers.items():
            if len(tracker.results) < self.total_frames:
                # The draw loop fails on the same condition with an
                # IndexError; fail as loudly here rather than truncate.
                raise ValueError(
                    f"tracker {name!r} has {len(tracker.results)} results for a "
                    f"{self.total_frames}-frame clip: inconsistent prediction cache (delete it "
                    "or run inference again)"
                )
        for frame_index in range(self.total_frames):
            players_detection = keypoints_detection = None
            for tracker in self.trackers.values():
                prediction = tracker.results[frame_index]
                if tracker.object() == Players:
                    # project_player writes .projection: a copy keeps the
                    # stored predictions as their caches hold them.
                    players_detection = deepcopy(prediction)
                elif tracker.object() == Keypoints:
                    keypoints_detection = prediction
            self.data_analytics = self.projected_court.collect_data_single_frame(
                keypoints_detection=keypoints_detection,
                players_detection=players_detection,
                data_analytics=self.data_analytics,
                is_fixed_keypoints=self.is_fixed_keypoints,
            )
            if self.data_analytics is not None:
                self.data_analytics.step(1)
        self._trim_trailing_frame()

    def draw_and_collect_data(self) -> None:
        """Render the annotated video with the minimap projections and
        collect the data; with render=False, collect only (and with
        neither, do nothing). Under a mesh only global rank 0 draws; the
        others collect only."""
        if not self.render or not self.is_writer:
            if self.data_analytics is not None:
                self.collect_data_only()
            return
        print(f"runner: Writing results into {self.inference_path}")
        with tracer.span("runner.collect"):
            writer = self._open_writer()
            try:
                for frame_index, frame in enumerate(self.frame_store):
                    self._draw_one(writer, frame_index, frame)
            except BaseException:
                writer.release()  # finalise the container (and free the shared encoder)
                raise
            self._finish_draw(writer)
        print("runner: Done.")
