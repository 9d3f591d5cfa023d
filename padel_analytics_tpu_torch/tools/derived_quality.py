"""The fast plan's ingest quality trade (derived wire buffer + pose at half
resolution) measured on TRAINED det and pose models.

Counterpart of the JAX package's ``tools/derived_quality_demo.py``. The fast
plan departs from the reference's preprocessing on two axes:

1. ``ingest='derived'``: every model input is derived on the device from one
   I420 wire buffer of the long side `wire` (a two-step resize) instead of a
   direct source-resolution resize per model;
2. pose at half its training resolution.

YOLOv8n detect and pose are trained on synthetic scenes with known truth
(detect on reference-parity letterboxed views, pose round-robin over three
squash sizes, the smoke analog of ultralytics' scale augmentation), then the
same weights run through the port's FusedPipeline at the reference plan
(i420 ingest, pose at full size) and the fast plan (derived ingest, pose at
half), with detect rate, box IoU, keypoint px and pose match rate against
the truth. Serving runs in the serving dtype of the device: bf16 through
kernel K1 (det, pose, TrackNet) and K2 on the card, fp32 on the CPU.

The geometry keeps production's ratios at 1/10 scale times `scale`: source
192x108 (1920x1080), wire 96 (960), pose 128 -> 64 (1280 -> 640), det
letterbox 64 (640). It is a frozen `Geometry` passed explicitly, so that two
scales can run in one process.

    python -m padel_analytics_tpu_torch.tools.derived_quality [--scale 5] [--isolate]
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from itertools import islice
from typing import Optional

import numpy as np
import torch

from ..config import BallTrackerConfig, PlayersTrackerConfig
from ..ops.polygon import PolygonZone
from ..ops.resize import letterbox_plan
from ..trackers import (
    BallTracker,
    FusedPipeline,
    Keypoint,
    Keypoints,
    KeypointsTracker,
    PlayerKeypointsTracker,
    PlayerTracker,
)
from ..training.state import init_train_state
from ..training.yolo import make_yolo_train_step
from ..utils.video import VideoInfo
from ._common import (
    StepTimer,
    device_argument,
    model_device,
    require_cv2,
    resolve_device,
    serving_dtype,
    shuffled_batches,
)
from .yolo_convergence import new_yolo, train_yolo

NK = 13  # PlayerKeypointsTracker's fixed keypoint count


@dataclass(frozen=True)
class Geometry:
    """The toy geometry at `scale` times 1/10 of production: every absolute
    pixel quantity (source, wire, model inputs, player boxes, keypoint dots)
    multiplies by `scale`, so the proportions stay production's while the
    features grow toward production's absolute sizes."""

    scale: int
    src_hw: tuple[int, int]  # (h, w)
    wire: int  # the derived ingest's long side
    pose_full: int
    pose_fast: int
    det: int  # the letterbox size

    @classmethod
    def at(cls, scale: int = 1, wire: Optional[int] = None) -> "Geometry":
        return cls(scale=scale, src_hw=(108 * scale, 192 * scale),
                   wire=96 * scale if wire is None else wire, pose_full=128 * scale,
                   pose_fast=64 * scale, det=64 * scale)


# 13 distinct dot colors (uint8 RGB) so the pose net can tell keypoints
# apart at smoke resolution; positions are a fixed grid inside the box.
_PALETTE = np.array(
    [
        [255, 64, 64], [64, 255, 64], [64, 64, 255], [255, 255, 64],
        [255, 64, 255], [64, 255, 255], [255, 160, 64], [160, 64, 255],
        [64, 160, 128], [200, 200, 200], [128, 255, 160], [255, 128, 160],
        [160, 128, 64],
    ],
    np.uint8,
)
_REL = np.array(
    [(0.5, 0.08)] + [(cx, cy) for cy in (0.28, 0.52, 0.76, 0.95) for cx in (0.2, 0.5, 0.8)],
    np.float32,
)  # (13, 2) relative keypoint layout inside the player box


def make_scene_clip(rng: np.random.Generator, n: int, m: int = 2,
                    geo: Geometry = Geometry.at(1)):
    """n source-resolution frames with m 'players' (shaded rects with 13
    colored keypoint dots) moving smoothly, and a ball dot. Returns (frames
    uint8 RGB, gt_boxes (n, m, 4) source px, gt_kpts (n, m, 13, 2) source px)."""
    h, w = geo.src_hw
    sc = geo.scale
    frames = np.empty((n, h, w, 3), np.uint8)
    gt_boxes = np.zeros((n, m, 4), np.float32)
    gt_kpts = np.zeros((n, m, NK, 2), np.float32)
    px = rng.uniform(10 * sc, w - 70 * sc, m)
    py = rng.uniform(5 * sc, h - 85 * sc, m)
    vx = rng.uniform(-1.5, 1.5, m) * sc
    vy = rng.uniform(-1.0, 1.0, m) * sc
    bw = rng.uniform(34 * sc, 48 * sc, m)
    bh = rng.uniform(64 * sc, 80 * sc, m)
    for i in range(n):
        f = np.full((h, w, 3), 38, np.uint8)
        f += rng.integers(0, 8, f.shape, dtype=np.uint8)
        for j in range(m):
            px[j] = np.clip(px[j] + vx[j], 2, w - bw[j] - 2)
            py[j] = np.clip(py[j] + vy[j], 2, h - bh[j] - 2)
            if px[j] in (2, w - bw[j] - 2):
                vx[j] = -vx[j]
            if py[j] in (2, h - bh[j] - 2):
                vy[j] = -vy[j]
            x1, y1 = px[j], py[j]
            x2, y2 = x1 + bw[j], y1 + bh[j]
            gt_boxes[i, j] = [x1, y1, x2, y2]
            f[int(y1): int(y2), int(x1): int(x2)] = (90 + 30 * j, 85, 110)
            for k in range(NK):
                kx = x1 + _REL[k, 0] * bw[j]
                ky = y1 + _REL[k, 1] * bh[j]
                gt_kpts[i, j, k] = [kx, ky]
                xi, yi = int(round(kx)), int(round(ky))
                # 5x5 dots at scale 1 (production's 20-60 px joints at 1/10),
                # the radius scaled with the geometry.
                r = 2 * sc
                f[max(yi - r, 0): yi + r + 1, max(xi - r, 0): xi + r + 1] = _PALETTE[k]
        # The ball: a bright dot on a sine path (its quality is
        # stride_quality's; here the ball branch only runs).
        bx = int((0.1 + 0.8 * (i / max(n - 1, 1))) * w)
        by = int(h * (0.3 + 0.2 * np.sin(i / 5.0)))
        f[max(by - sc, 0): by + sc + 1, max(bx - sc, 0): bx + sc + 1] = 255
        frames[i] = f
    return frames, gt_boxes, gt_kpts


# ------------------------------------------------------------ training


def _letterbox_train_views(frames, gt_boxes, geo: Geometry):
    """Reference-parity det training inputs: a direct source -> letterbox
    (the plan PlayerTracker runs, `ops.resize.letterbox_plan`) with cv2's
    linear resize. Returns (images fp32 in [0, 1], boxes in letterbox px,
    (out_h, out_w))."""
    cv2 = require_cv2()
    lb = letterbox_plan(geo.src_hw, geo.det)
    new_h, new_w = lb.plan.dst_hw
    out = np.full((len(frames), lb.out_h, lb.out_w, 3), 114, np.uint8)
    for i, f in enumerate(frames):
        r = cv2.resize(f, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        out[i, lb.pad_top: lb.pad_top + new_h, lb.pad_left: lb.pad_left + new_w] = r
    boxes = gt_boxes * lb.gain
    boxes[..., 0::2] += lb.pad_left
    boxes[..., 1::2] += lb.pad_top
    return out.astype(np.float32) / 255.0, boxes, (lb.out_h, lb.out_w)


def _squash_train_views(frames, gt_boxes, gt_kpts, size: int, geo: Geometry):
    """Reference-parity pose training inputs: a direct source -> size x size
    squash with cv2's linear resize. Returns (images fp32 in [0, 1], boxes,
    keypoints (..., 13, 3) with visibility 2)."""
    cv2 = require_cv2()
    h, w = geo.src_hw
    out = np.stack([cv2.resize(f, (size, size), interpolation=cv2.INTER_LINEAR)
                    for f in frames])
    sx, sy = size / w, size / h
    boxes = gt_boxes * np.array([sx, sy, sx, sy], np.float32)
    kpts = np.concatenate(
        [gt_kpts * np.array([sx, sy], np.float32),
         np.full(gt_kpts.shape[:-1] + (1,), 2.0, np.float32)],
        axis=-1,
    )
    return out.astype(np.float32) / 255.0, boxes, kpts


def pose_sizes(geo: Geometry) -> tuple[int, int, int]:
    """The multi-scale pose training sizes: full, the halfway point rounded
    to a multiple of 32, and half."""
    mid = round((geo.pose_full + geo.pose_fast) / 2 / 32) * 32
    return geo.pose_full, mid, geo.pose_fast


def _train_pose_multiscale(model, frames, boxes, kpts, steps: int, batch: int, lr: float,
                           geo: Geometry, sizes=None, seed: int = 0):
    """Train the pose model round-robin over squash sizes (step k at
    sizes[k % 3]), the batches a `shuffled_batches` of `seed`'s rng: a
    model trained at one resolution is maximally scale-brittle, which real
    checkpoints are not. Returns (model, the last loss, the step timer)."""
    sizes = pose_sizes(geo) if sizes is None else sizes
    state = init_train_state(model, lr)
    views = {s: _squash_train_views(frames, boxes, kpts, s, geo) for s in sizes}
    step_fn = make_yolo_train_step(pose=True)
    labels = np.zeros(boxes.shape[:2], np.int32)
    mask = np.ones(boxes.shape[:2], bool)
    rng = np.random.default_rng(seed)
    dev = model_device(model)
    loss, timer = float("nan"), StepTimer()
    for step, sel in enumerate(islice(shuffled_batches(rng, len(frames), batch), steps)):
        imgs, gtb, gtk = views[sizes[step % len(sizes)]]
        args = [torch.from_numpy(a[sel]).to(dev) for a in (imgs, labels, gtb, gtk, mask)]
        timer.start()
        state, loss_t = step_fn(state, *args)
        loss = float(loss_t)
        timer.stop()
    return model, loss, timer


def _train(model, images, steps: int, batch: int, lr: float, pose: bool, gts, seed: int = 0):
    """`steps` Adam steps over `seed`'s shuffled batches of (images, *gts);
    returns (model, the last loss, the step timer)."""
    state = init_train_state(model, lr)
    losses, timer = train_yolo(state, (images,) + tuple(gts), steps, batch,
                               np.random.default_rng(seed), pose=pose)
    return model, (losses[-1] if losses else float("nan")), timer


# ------------------------------------------------------------ evaluation


def _build_pipeline(det_model, pose_model, pose_size: int, ingest: str, n: int,
                    geo: Geometry, wire: Optional[int] = None) -> FusedPipeline:
    """The four trackers on the models' device (the serving dtype there),
    the trained weights copied in, a random-weight 48x80 TrackNet and a
    fixed court; a FusedPipeline at chunk 8 over them."""
    dev = model_device(det_model)
    dtype = serving_dtype(dev)
    h, w = geo.src_hw
    poly = np.array([[2, 2], [w - 2, 2], [w - 2, h - 2], [2, h - 2]])
    players = PlayerTracker(
        None, PolygonZone(poly, (w, h)), compute_dtype=dtype, device=dev,
        config=PlayersTrackerConfig(model_variant="n", batch_size=8, conf=0.25, imgsz=geo.det),
    )
    players.engine.model.load_state_dict(det_model.state_dict())
    pose = PlayerKeypointsTracker(None, train_image_size=pose_size, batch_size=8,
                                  model_variant="n", compute_dtype=dtype, device=dev)
    pose.engine.model.load_state_dict(pose_model.state_dict())
    ball = BallTracker(None, None, compute_dtype=dtype, device=dev,
                       config=BallTrackerConfig(height=48, width=80, batch_size=8,
                                                median_max_sample_num=8))
    kps = [(w * x, h * y) for x, y in
           [(0.1, 0.9), (0.9, 0.9), (0.1, 0.7), (0.5, 0.7), (0.9, 0.7),
            (0.12, 0.5), (0.88, 0.5), (0.14, 0.3), (0.5, 0.3), (0.86, 0.3),
            (0.16, 0.15), (0.84, 0.15)]]
    court = KeypointsTracker(
        fixed_keypoints_detection=Keypoints(
            [Keypoint(id=i, xy=(float(x), float(y))) for i, (x, y) in enumerate(kps)]),
        device=dev,
    )
    info = VideoInfo(width=w, height=h, fps=30.0, total_frames=n)
    for t in (players, pose, ball, court):
        t.video_info_post_init(info)
    return FusedPipeline(players, pose, ball, court, chunk=8, ingest=ingest,
                         wire_long_side=geo.wire if wire is None else wire)


def _eval_outputs(results, gt_boxes, gt_kpts) -> dict:
    """Match predictions to the truth frame by frame: detect_rate (a box of
    IoU >= 0.3), mean_iou of those, kpt_px (mean keypoint distance of the
    best pose set whose centroid lies in the player's box dilated 25% a
    side) and pose_match_rate (a player with such a set). The gate keeps a
    pose set of one player from being scored against another: recall and
    keypoint precision stay apart."""
    n, m = gt_boxes.shape[:2]
    ious, kpt_err, found, pose_found = [], [], 0, 0
    for i in range(n):
        preds = [np.array(p.xyxy, np.float32) for p in results["players"][i]]
        pose_sets = []
        for pk in results["players_keypoints"][i]:
            pts = np.array([kp.xy for kp in pk.player_keypoints], np.float32)
            if pts.shape == (NK, 2):
                pose_sets.append(pts)
        for j in range(m):
            g = gt_boxes[i, j]
            best_iou = 0.0
            for b in preds:
                ix1, iy1 = max(g[0], b[0]), max(g[1], b[1])
                ix2, iy2 = min(g[2], b[2]), min(g[3], b[3])
                inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
                union = ((g[2] - g[0]) * (g[3] - g[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)
                best_iou = max(best_iou, inter / max(union, 1e-9))
            if best_iou >= 0.3:
                found += 1
                ious.append(best_iou)
            dx = 0.25 * (g[2] - g[0])
            dy = 0.25 * (g[3] - g[1])
            gk = gt_kpts[i, j]
            best_err = None
            for pts in pose_sets:
                cx, cy = pts.mean(axis=0)
                if not (g[0] - dx <= cx <= g[2] + dx and g[1] - dy <= cy <= g[3] + dy):
                    continue
                err = float(np.hypot(*(pts - gk).T).mean())
                if best_err is None or err < best_err:
                    best_err = err
            if best_err is not None:
                pose_found += 1
                kpt_err.append(best_err)
    return {
        "detect_rate": found / (n * m),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "kpt_px": float(np.mean(kpt_err)) if kpt_err else float("inf"),
        "pose_match_rate": pose_found / (n * m),
    }


def eval_jobs(geo: Geometry, pose_fast: Optional[int] = None, isolate: bool = False,
              wire_sweep: tuple[int, ...] = ()) -> list[tuple[str, str, int, Optional[int]]]:
    """(name, ingest, pose size, wire or None) of each served config: the
    parity and fast plans; with `isolate` the two off-diagonal configs
    (derived ingest with pose at full size, i420 with pose at half), which
    attribute the fast plan's cost to its two axes; each extra wire of
    `wire_sweep` on the fast plan."""
    pf = geo.pose_fast if pose_fast is None else pose_fast
    jobs = [("parity", "i420", geo.pose_full, None), ("fast", "derived", pf, None)]
    if isolate:
        jobs += [("derived_fullpose", "derived", geo.pose_full, None),
                 ("i420_halfpose", "i420", pf, None)]
    jobs += [(f"fast_wire{wv}", "derived", pf, wv) for wv in wire_sweep if wv != geo.wire]
    return jobs


def serve_grid(det_model, pose_model, geo: Geometry, ev, jobs, verbose: bool = False) -> dict:
    """Each job of `eval_jobs` through a fresh FusedPipeline on the models'
    device over the evaluation frames; {config: `_eval_outputs`}."""
    frames, boxes, kpts = ev
    grid = {}
    for name, ingest, psize, wv in jobs:
        pipe = _build_pipeline(det_model, pose_model, psize, ingest, len(frames), geo, wire=wv)
        results = pipe.run(iter([f for f in frames]), len(frames))
        grid[name] = _eval_outputs(results, boxes, kpts)
        if verbose:
            print(f"{name} (ingest={ingest}, pose@{psize}, "
                  f"wire={geo.wire if wv is None else wv}): {grid[name]}", flush=True)
    return grid


def run_demo(det_steps: int = 150, pose_steps: int = 200, n_frames: int = 48,
             n_train: int = 24, verbose: bool = True, device="cuda",
             wire: Optional[int] = None, pose_fast: Optional[int] = None,
             wire_sweep: tuple[int, ...] = (), isolate: bool = False, scale: int = 1,
             det_init: Optional[dict] = None, pose_init: Optional[dict] = None) -> dict:
    """Train once, then serve every config of `eval_jobs` through the fused
    pipeline. Returns {"grid": {config: metrics}, "geometry", "det_loss",
    "pose_loss", "det_step_ms", "pose_step_ms", "wall_s", "det", "pose",
    "eval": (frames, boxes, kpts)}; `wire` and `wire_sweep` are in scaled
    units."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    geo = Geometry.at(scale, wire)
    rng = np.random.default_rng(0)
    tr_frames, tr_boxes, tr_kpts = make_scene_clip(rng, n_train, geo=geo)
    ev_frames, ev_boxes, ev_kpts = make_scene_clip(rng, n_frames, geo=geo)

    # Detect on reference-parity letterboxed views.
    det_imgs, det_gtb, _ = _letterbox_train_views(tr_frames, tr_boxes, geo)
    labels = np.zeros(tr_boxes.shape[:2], np.int32)
    mask = np.ones(tr_boxes.shape[:2], bool)
    det_model = new_yolo(dev, init=det_init).model
    det_model, det_loss, det_timer = _train(det_model, det_imgs, det_steps, 8, 2e-3, False,
                                            (labels, det_gtb, mask))
    if verbose:
        print(f"det trained ({det_steps} steps, final loss {det_loss:.3f})", flush=True)

    # Pose multi-scale over the squash sizes, like real checkpoints' scale
    # augmentation.
    pose_model = new_yolo(dev, NK, init=pose_init).model
    pose_model, pose_loss, pose_timer = _train_pose_multiscale(
        pose_model, tr_frames, tr_boxes, tr_kpts, pose_steps, 4, 2e-3, geo)
    if verbose:
        print(f"pose trained ({pose_steps} steps, final loss {pose_loss:.3f})", flush=True)

    ev = (ev_frames, ev_boxes, ev_kpts)
    grid = serve_grid(det_model, pose_model, geo, ev,
                      eval_jobs(geo, pose_fast, isolate, wire_sweep), verbose)
    return {"grid": grid, "geometry": geo, "det_loss": det_loss, "pose_loss": pose_loss,
            "det_step_ms": det_timer.median_ms(), "pose_step_ms": pose_timer.median_ms(),
            "wall_s": time.perf_counter() - t0, "det": det_model, "pose": pose_model,
            "eval": ev}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--det-steps", type=int, default=150)
    ap.add_argument("--pose-steps", type=int, default=200)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--wire", type=int, default=None,
                    help="wire long side (default 96 x scale = 960/10); sweep with e.g. 72, 80")
    ap.add_argument("--pose-fast", type=int, default=None)
    ap.add_argument("--wire-sweep", default="",
                    help="comma-separated extra wire settings served with the same trained "
                         "models, e.g. 72,80")
    ap.add_argument("--isolate", action="store_true",
                    help="also serve the two off-diagonal configs (derived + pose@full, "
                         "i420 + pose@half) to attribute the fast plan's cost to its two axes")
    ap.add_argument("--scale", type=int, default=1,
                    help="geometry multiplier: 1 = 1/10 production scale, 5 = 1/2; --wire "
                         "and --wire-sweep are in scaled units")
    device_argument(ap)
    args = ap.parse_args(argv)
    sweep = tuple(int(v) for v in args.wire_sweep.split(",") if v)
    run_demo(det_steps=args.det_steps, pose_steps=args.pose_steps, n_frames=args.frames,
             wire=args.wire, pose_fast=args.pose_fast, wire_sweep=sweep, isolate=args.isolate,
             scale=args.scale, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
