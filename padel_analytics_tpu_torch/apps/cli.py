"""The pipeline's command line: the reference's main.py.

    python -m padel_analytics_tpu_torch.apps.cli --config config.py
    python -m padel_analytics_tpu_torch.apps.cli --device cpu --input-video clip.mp4 \
        --keypoints court.json --no-render

Counterpart of ``padel_analytics_tpu/apps/cli.py``: probe the video, take
the 12 court keypoints (a JSON file, or the click tool where a display
exists), build the on-court polygon from keypoints 0, 1, -1 and -2, build
the four trackers, run the `TrackingRunner` and write data.csv (with the
port's pandas-free writer). The config is a reference-style flat module
(`--config`, read by `PipelineConfig.from_module`) or the flags below.

The runner takes the fused single-upload pipeline, which falls back to the
per-tracker paths by itself (a short clip, a loaded cache). The models run
on the card unless `--device cpu` is given; the JAX package's `--pallas`
has no counterpart (on the card, the hand-written kernels are the path).
`run_pipeline` also takes a decoded clip in memory (`MemoryClip`) in place
of the configured video path, for a host without a video decoder.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import timeit
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import PipelineConfig
from ..ops.polygon import PolygonZone
from ..trackers import (
    BallTracker,
    Keypoint,
    Keypoints,
    KeypointsTracker,
    PlayerKeypointsTracker,
    PlayerTracker,
    TrackingRunner,
)
from ..utils.video import MemoryClip, VideoInfo, frame_generator


def load_config_file(path: str | Path) -> PipelineConfig:
    """A PipelineConfig from a reference-style flat config .py file."""
    spec = importlib.util.spec_from_file_location("user_config", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return PipelineConfig.from_module(module)


def _load_config(args) -> PipelineConfig:
    cfg = load_config_file(args.config) if args.config else PipelineConfig()
    if args.input_video:
        cfg.input_video_path = args.input_video
    if args.output_video:
        cfg.output_video_path = args.output_video
    if args.max_frames is not None:
        cfg.max_frames = args.max_frames
    if args.keypoints:
        cfg.fixed_court_keypoints_load_path = args.keypoints
    if args.data_csv:
        cfg.collect_data_path = args.data_csv
    if args.no_collect:
        cfg.collect_data = False
    if args.no_render:
        cfg.render_video = False
    if args.render_scale is not None:
        cfg.render_scale = args.render_scale
    if args.variant:
        cfg.players.model_variant = args.variant
        cfg.player_keypoints.model_variant = args.variant
        cfg.court_keypoints.model_variant = args.variant
    return cfg


def _acquire_keypoints(cfg: PipelineConfig, video: str | Path | MemoryClip,
                       interactive: bool = True) -> list:
    """The fixed court keypoints from their JSON file, or else from the
    click tool on the first frame. `interactive=False` raises instead of
    opening a window. The selection is validated before it is saved, so an
    invalid one never reaches the file a later run loads."""
    if cfg.fixed_court_keypoints_load_path:
        with open(cfg.fixed_court_keypoints_load_path) as f:
            selected = json.load(f)
    elif not interactive:
        raise RuntimeError(
            "no fixed court keypoints JSON configured (FIXED_COURT_KEYPOINTS_LOAD_PATH or "
            "--keypoints) and the interactive click tool is not available here"
        )
    else:
        from .keypoint_picker import pick_keypoints

        selected = pick_keypoints(next(frame_generator(video, end=1)), window="frame")
    if len(selected) != 12:
        raise SystemExit(f"expected 12 court keypoints, got {len(selected)} "
                         "(give a --keypoints JSON where there is no display)")
    if cfg.fixed_court_keypoints_save_path:
        with open(cfg.fixed_court_keypoints_save_path, "w") as f:
            json.dump(selected, f)
    return selected


def build_pipeline(cfg: PipelineConfig, interactive: bool = True, device: str = "cuda",
                   video: Optional[MemoryClip] = None) -> TrackingRunner:
    """The four trackers and their runner from a PipelineConfig, over
    `video` when given, else over cfg.input_video_path."""
    video = cfg.input_video_path if video is None else video
    video_info = VideoInfo.from_video_path(video)
    selected = _acquire_keypoints(cfg, video, interactive)
    fixed_keypoints_detection = Keypoints(
        [Keypoint(id=i, xy=tuple(float(x) for x in v)) for i, v in enumerate(selected)])
    arr = np.array(selected)
    polygon_zone = PolygonZone(np.stack([arr[0], arr[1], arr[-1], arr[-2]]),
                               frame_resolution_wh=video_info.resolution_wh)
    trackers = [
        PlayerTracker(None, polygon_zone=polygon_zone, load_path=cfg.players.load_path,
                      save_path=cfg.players.save_path, config=cfg.players, device=device),
        PlayerKeypointsTracker(None, load_path=cfg.player_keypoints.load_path,
                               save_path=cfg.player_keypoints.save_path,
                               config=cfg.player_keypoints, device=device),
        BallTracker(None, load_path=cfg.ball.load_path, save_path=cfg.ball.save_path,
                    config=cfg.ball, device=device),
        KeypointsTracker(fixed_keypoints_detection=fixed_keypoints_detection,
                         load_path=cfg.court_keypoints.load_path,
                         save_path=cfg.court_keypoints.save_path, config=cfg.court_keypoints),
    ]
    return TrackingRunner(
        trackers=trackers,
        video_path=video,
        inference_path=cfg.output_video_path,
        start=0,
        end=cfg.max_frames,
        collect_data=cfg.collect_data,
        fused=True,
        render=cfg.render_video,
        render_scale=cfg.render_scale,
    )


def run_pipeline(cfg: PipelineConfig, video: Optional[MemoryClip] = None, device: str = "cuda",
                 interactive: bool = True) -> TrackingRunner:
    """Build and run the pipeline, then write data.csv when collecting."""
    runner = build_pipeline(cfg, interactive=interactive, device=device, video=video)
    runner.run()
    if cfg.collect_data and runner.data_analytics is not None:
        runner.write_csv(cfg.collect_data_path)
        print(f"cli: analytics written to {cfg.collect_data_path}")
    return runner


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="padel-analytics-tpu-torch",
        description="padel video analytics pipeline (PyTorch / CUDA)",
    )
    parser.add_argument("--config", help="reference-style flat config .py module")
    parser.add_argument("--input-video", help="input video path")
    parser.add_argument("--output-video", help="annotated output video path")
    parser.add_argument("--keypoints", help="fixed court keypoints JSON (12 [x, y])")
    parser.add_argument("--data-csv", help="analytics CSV output path")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--no-collect", action="store_true")
    parser.add_argument("--no-render", action="store_true",
                        help="skip the annotated video (no decode, drawing or encode after "
                             "inference; data.csv is still written)")
    parser.add_argument("--render-scale", type=float, default=None,
                        help="encode the annotated video at this fraction of the source size "
                             "(drawn and collected at full size)")
    parser.add_argument("--variant", help="YOLOv8 variant override (n/s/m/l/x)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the models run (default: the card)")
    args = parser.parse_args(argv)

    t1 = timeit.default_timer()
    run_pipeline(_load_config(args), device=args.device)
    t2 = timeit.default_timer()
    print("Duration (min): ", (t2 - t1) / 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
