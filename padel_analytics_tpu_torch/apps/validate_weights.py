"""Real-weight golden validation: the one command for the north-star
"detections within 1 px of the reference" check, on the port's pipeline.

Counterpart of ``padel_analytics_tpu/apps/validate_weights.py``. Given a
directory of reference checkpoints and a directory of JSON prediction
caches the reference wrote (its tracker.py, with the paths of its
config.py), this command

  1. loads each checkpoint through the port's loaders (the trackers read the
     reference's .pt formats: an ultralytics YOLOv8 .pt, a TrackNet /
     InpaintNet ``{'model', 'param_dict'}`` file, a resnet50 state_dict),
  2. runs the fused pipeline on the clip (the reference plan; on the card in
     bf16 through the port's kernels), writing the port's caches,
  3. compares every tracker's cache with the reference's through
     apps/compare_predictions.py's comparators,
  4. writes one JSON report with each tracker's pixel deltas and a combined
     <= 1 px verdict.

Weights layout (any may be absent):
  <weights_dir>/players.pt        ultralytics YOLOv8m detection
  <weights_dir>/pose.pt           ultralytics YOLOv8m-pose (13 kpts)
  <weights_dir>/tracknet.pt       TrackNet ckpt with param_dict
  <weights_dir>/inpaintnet.pt     InpaintNet ckpt (optional)
  <weights_dir>/court.pt          court model (yolo 12-kpt or resnet50)

Reference-cache layout (the reference's config.py names):
  <cache_dir>/players_detections.json
  <cache_dir>/players_keypoints_detections.json
  <cache_dir>/ball_detections.json
  <cache_dir>/keypoints_detections.json

A missing cache marks its tracker "skipped" (exit 0 unless --strict); a
missing checkpoint runs that tracker on seeded random weights, as the JAX
app does, and the report says which were present. `--fast-path` also runs
the JAX package's headline plan (derived ingest, pose at --fast-pose-size)
and reports its deltas against this run's reference-plan caches.

  python -m padel_analytics_tpu_torch.apps.validate_weights \\
      --weights-dir weights/ --cache-dir ref_caches/ \\
      --video rally.mp4 --keypoints source_keypoints.json \\
      --out report.json [--strict] [--max-frames N] [--device cuda|cpu]

The models run on the card (bf16, as the JAX app runs them) unless
`--device cpu` is given (fp32). The run writes no annotated video: the
report reads only the caches. `build_and_run` also takes a decoded clip
(`video=MemoryClip`) in place of --video, as `apps.cli.run_pipeline` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path


def build_and_run(args, weights: dict, tmp: Path, fast_path: bool = False,
                  video=None) -> dict:
    """Run the pipeline with the given weights; returns {kind: cache_path}
    of the caches this run wrote.

    fast_path=True runs the JAX package's headline plan instead of the
    reference one: ingest='derived' (a wire buffer of long side at most
    --fast-wire-long-side) and pose at --fast-pose-size. `video`: a
    `MemoryClip` in place of args.video."""
    import numpy as np
    import torch

    from ..config import BallTrackerConfig
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
    from ..utils.video import VideoInfo

    if video is None:
        video = args.video
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise ImportError(f"validate_weights: reading the video {video} needs OpenCV (cv2), "
                              "which is not installed; pass a decoded clip "
                              "(build_and_run(video=MemoryClip(...)))") from e
    device = getattr(args, "device", "cuda")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"validate_weights: device {device}: no CUDA device here "
                           "(pass --device cpu)")
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32

    info = VideoInfo.from_video_path(video)
    with open(args.keypoints) as f:
        pts = json.load(f)
    kp = Keypoints([Keypoint(id=i, xy=(float(x), float(y))) for i, (x, y) in enumerate(pts)])
    polygon = np.array([pts[0], pts[1], pts[-1], pts[-2]])

    ours: dict = {}
    players = PlayerTracker(
        weights.get("players"),
        PolygonZone(polygon, (info.width, info.height)),
        batch_size=8,
        model_variant=args.variant,
        compute_dtype=dtype,
        save_path=tmp / "players.json",
        device=device,
    )
    ours["players"] = str(tmp / "players.json")
    pose = PlayerKeypointsTracker(
        weights.get("pose"),
        train_image_size=getattr(args, "fast_pose_size", 640) if fast_path else 1280,
        batch_size=8,
        model_variant=args.variant,
        compute_dtype=dtype,
        save_path=tmp / "players_keypoints.json",
        device=device,
    )
    ours["players_keypoints"] = str(tmp / "players_keypoints.json")
    ball = BallTracker(
        weights.get("tracknet"),
        weights.get("inpaintnet"),
        config=BallTrackerConfig(batch_size=8),
        compute_dtype=dtype,
        save_path=tmp / "ball.json",
        device=device,
    )
    ours["ball"] = str(tmp / "ball.json")
    if weights.get("court"):
        # With a court checkpoint the court model itself is validated (the
        # fixed keypoints would make the 'keypoints' comparison vacuous).
        court = KeypointsTracker(
            weights["court"],
            batch_size=8,
            model_type=_court_model_type(args, weights["court"]),
            model_variant=args.variant,
            compute_dtype=dtype,
            save_path=tmp / "keypoints.json",
            device=device,
        )
    else:
        court = KeypointsTracker(fixed_keypoints_detection=kp, save_path=tmp / "keypoints.json",
                                 device=device)
    ours["keypoints"] = str(tmp / "keypoints.json")

    fused_kwargs = {}
    if fast_path:
        fused_kwargs = {
            "fused_ingest": "derived",
            "fused_wire_long_side": getattr(args, "fast_wire_long_side", 960),
        }
    runner = TrackingRunner(
        [players, pose, ball, court],
        video,
        str(tmp / "out.mp4"),
        end=args.max_frames,
        collect_data=False,
        fused=True,
        render=False,
        **fused_kwargs,
    )
    runner.run()
    return ours


def _court_model_type(args, path: str) -> str:
    """'yolo' or 'resnet' for court.pt: the flag when given, else inferred
    from the checkpoint (an ultralytics pickle carries a 'model' module or
    dict; a resnet state_dict has flat keys like 'layer1.0.conv1.weight')."""
    if args.court_model_type != "auto":
        return args.court_model_type
    from ..models.convert import load_torch_checkpoint

    ckpt = load_torch_checkpoint(path, allow_pickle=True)
    if isinstance(ckpt, dict):
        keys = set(ckpt.keys())
        if "model" in keys or "ema" in keys:
            return "yolo"
        if any(k.startswith(("layer", "fc.", "conv1.")) for k in keys):
            return "resnet"
    if hasattr(ckpt, "state_dict"):
        keys = set(ckpt.state_dict().keys())
        if any(k.startswith(("layer", "fc.", "conv1.")) for k in keys):
            return "resnet"
    return "yolo"


REF_CACHE_NAMES = {
    "players": "players_detections.json",
    "players_keypoints": "players_keypoints_detections.json",
    "ball": "ball_detections.json",
    "keypoints": "keypoints_detections.json",
}

WEIGHT_NAMES = {
    "players": "players.pt",
    "pose": "pose.pt",
    "tracknet": "tracknet.pt",
    "inpaintnet": "inpaintnet.pt",
    "court": "court.pt",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="validate_weights")
    parser.add_argument("--weights-dir", required=True)
    parser.add_argument("--cache-dir", required=True,
                        help="reference-produced JSON caches")
    parser.add_argument("--video", required=True)
    parser.add_argument("--keypoints", required=True,
                        help="fixed court keypoints JSON (12 [x,y])")
    parser.add_argument("--out", default="validation_report.json")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--variant", default="m")
    parser.add_argument(
        "--court-model-type", default="auto",
        choices=("auto", "yolo", "resnet"),
        help="court.pt architecture; 'auto' infers from the checkpoint",
    )
    parser.add_argument("--strict", action="store_true",
                        help="non-zero exit when anything is skipped or >1px")
    parser.add_argument(
        "--fast-path", action="store_true",
        help="ALSO run the JAX package's headline plan (ingest='derived' + "
        "pose@--fast-pose-size) and report its per-tracker px deltas against "
        "this run's reference-plan outputs",
    )
    parser.add_argument("--fast-wire-long-side", type=int, default=960)
    parser.add_argument("--fast-pose-size", type=int, default=640)
    parser.add_argument(
        "--fast-bound", type=float, default=5.0,
        help="px bound for the fast-path verdict (vs parity outputs)",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the models run (default: the card)")
    return parser.parse_args(argv)


def _compare(kind: str, ours: str, theirs: str) -> dict:
    from .compare_predictions import COMPARATORS

    with open(ours) as f:
        a = json.load(f)
    with open(theirs) as f:
        b = json.load(f)
    return COMPARATORS[kind](a, b)


def np_isfinite(x) -> bool:
    """Whether `x` is finite, as a Python bool."""
    import numpy as np

    return bool(np.isfinite(x))


def _worst(stats: dict, worst: float) -> float:
    if "max_px" in stats and np_isfinite(stats["max_px"]):
        return max(worst, stats["max_px"])
    return worst


def main(argv=None, video=None) -> int:
    """The command; `video`: a `MemoryClip` to run in place of --video."""
    args = parse_args(argv)
    wdir = Path(args.weights_dir)
    weights = {
        k: str(wdir / name) if (wdir / name).exists() else None
        for k, name in WEIGHT_NAMES.items()
    }
    present = [k for k, v in weights.items() if v]
    print(f"validate: weights present: {present or 'NONE (random init)'}")

    tmp = Path(tempfile.mkdtemp(prefix="pat_validate_"))
    ours = build_and_run(args, weights, tmp, video=video)

    report: dict = {"weights": {k: bool(v) for k, v in weights.items()}}
    worst = 0.0
    skipped = []
    for kind, ref_name in REF_CACHE_NAMES.items():
        ref_path = Path(args.cache_dir) / ref_name
        if not ref_path.exists():
            report[kind] = "skipped: no reference cache"
            skipped.append(kind)
            continue
        stats = _compare(kind, ours[kind], ref_path)
        report[kind] = stats
        worst = _worst(stats, worst)

    report["max_px_overall"] = worst
    report["within_1px_verdict"] = bool(worst <= 1.0) and not skipped

    fast_fail = False
    if args.fast_path:
        # A second run in the headline plan, compared with THIS run's
        # reference-plan caches (not the reference's): the fast plan's own
        # quality trade on these weights.
        fast_tmp = tmp / "fast"
        fast_tmp.mkdir()
        fast = build_and_run(args, weights, fast_tmp, fast_path=True, video=video)
        section: dict = {
            "config": {
                "ingest": "derived",
                "wire_long_side": args.fast_wire_long_side,
                "pose_image_size": args.fast_pose_size,
            }
        }
        worst_fast = 0.0
        for kind in REF_CACHE_NAMES:
            stats = _compare(kind, fast[kind], ours[kind])
            section[kind] = stats
            worst_fast = _worst(stats, worst_fast)
        section["max_px_vs_parity"] = worst_fast
        section["within_bound_verdict"] = bool(worst_fast <= args.fast_bound)
        report["fast_path"] = section
        fast_fail = not section["within_bound_verdict"]

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"validate: report written to {args.out}")
    if args.strict and (skipped or worst > 1.0 or fast_fail):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
