"""One run of one cell: set-up, the measured window over the port's main
path, then the check against the plain reference.

The window drives what a user runs for each clip of a batch (the body of
the CLI for one video): `TrackingRunner([players, pose, ball, court],
MemoryClip(frames, fps), tmp, fused=True, fused_chunk=..., collect_data=True,
render=False)`, `restart()`, its `run()` (inference, each tracker's JSON
cache, the collect pass) and `write_csv`, clip after clip from the pool:
one runner, handed the next clip of the pool before each `restart()`.
Set-up runs it once, on the pool's first clip; window clip i runs pool
clip (i + 1) % len(pool), so that every clip of the window, its first
too, computes the ball's median anew. The window ends with the first clip
that ends once `seconds` have passed; its time runs from the first clip's
start to that clip's end. A traced run profiles its first clip and reads
its per-layer metrics from it and from the clips after it.
"""

from __future__ import annotations

import gc
import importlib
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import check, flops, scene, trace, weights
from .manifest import Manifest

PACKAGE = "padel_analytics_tpu_torch"
#: Top-level modules that must not be loaded when the result is printed.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "padel_analytics_tpu")


@dataclass
class Record:
    """What a run measured, for the metric readers."""

    clips: list = field(default_factory=list)  # per clip: frames, seconds, collect_s, traced
    trace: trace.Trace | None = None
    k1_calls: list = field(default_factory=list)
    flops_per_frame: dict = field(default_factory=dict)
    profile: tuple | None = None  # (the profiler, the traced clip's seconds)


def _trackers(cfg: dict, hw, wts: dict, tmp: Path, device: str) -> list:
    """The port's four trackers at the configuration, the seeded weights
    loaded into their models, each saving its JSON cache under `tmp`."""
    from padel_analytics_tpu_torch.config import (
        BallTrackerConfig, CourtKeypointsTrackerConfig, PlayersTrackerConfig)
    from padel_analytics_tpu_torch.models.tracknet import InpaintNet
    from padel_analytics_tpu_torch.ops.polygon import PolygonZone
    from padel_analytics_tpu_torch.trackers import (
        BallTracker, KeypointsTracker, PlayerKeypointsTracker, PlayerTracker)
    from padel_analytics_tpu_torch.trackers._engine import Engine
    from padel_analytics_tpu_torch.trackers.objects import Keypoint, Keypoints

    from .reference.pipeline import scaled

    p, q, b, c = cfg["players"], cfg["pose"], cfg["ball"], cfg["court"]
    h, w = hw
    players = PlayerTracker(
        None, polygon_zone=PolygonZone(scaled(p["polygon"], hw), (w, h)), device=device,
        config=PlayersTrackerConfig(model_variant=p["variant"], conf=p["conf"], iou=p["iou"],
                                    imgsz=p["imgsz"], max_detections=p["max_detections"],
                                    num_classes=p["num_classes"], nms_top_k=p["nms_top_k"]),
        save_path=tmp / "players.json")
    # Built from its arguments: the config object admits only the reference's
    # 640 and 1280 squashes, and the tests run smaller ones.
    pose = PlayerKeypointsTracker(
        None, train_image_size=q["train_image_size"], model_variant=q["variant"],
        max_detections=q["max_detections"], device=device, save_path=tmp / "pose.json")
    pose.CONF, pose.IOU, pose.nms_top_k = q["conf"], q["iou"], q["nms_top_k"]
    ball = BallTracker(None, device=device, save_path=tmp / "ball.json", config=BallTrackerConfig(
        seq_len=b["seq_len"], bg_mode=b["bg_mode"], height=b["height"], width=b["width"],
        median_max_sample_num=b["median_max_sample_num"], eval_mode=b["eval_mode"]))
    players.engine.model.load_state_dict(wts["players"])
    pose.engine.model.load_state_dict(wts["pose"])
    ball.tracknet.model.load_state_dict(wts["tracknet"])
    if b.get("inpaintnet"):
        # The tracker builds its InpaintNet from a checkpoint file; the
        # benchmark hands it the seeded one directly.
        ball.inpaintnet = Engine(InpaintNet(), device, wts["inpaintnet"])
        ball.inpaintnet_seq_len = b["inpaint_seq_len"]
    if c["mode"] == "fixed":
        court = KeypointsTracker(fixed_keypoints_detection=Keypoints([
            Keypoint(id=i, xy=(float(x), float(y)))
            for i, (x, y) in enumerate(scaled(c["keypoints"], hw))]),
            save_path=tmp / "court.json", device=device)
    else:
        court = KeypointsTracker(config=CourtKeypointsTrackerConfig(
            model_type="yolo", model_variant=c["variant"], train_image_size=c["train_image_size"],
            conf=c["conf"], iou=c["iou"]), save_path=tmp / "court.json", device=device)
        court.engine.model.load_state_dict(wts["court"])
    return [players, pose, ball, court]


class Cell:
    """A cell's set-up, window and check on `device` ('cuda' on the card;
    the tests drive 'cpu' at tiny sizes)."""

    def __init__(self, manifest: Manifest, workload: str, seed: int, device: str = "cuda"):
        self.spec = manifest.workload(workload)
        self.cfg = manifest.config(self.spec["config"])
        self.traffic = manifest.traffic(self.spec["traffic"])
        self.limits = manifest.limits(workload)
        self.seed, self.device = seed, device
        self.hw = tuple(self.traffic["frame_hw"])
        self.n = self.cfg["max_frames"]

    def prepare(self) -> None:
        """The inputs made from the seed: the clip pool, the weights and
        their calibration (on the first clip's first 16 frames)."""
        self.pool = scene.make_pool(self.traffic, self.n, self.seed)
        self.wts = weights.make_weights(self.cfg, self.seed, self.device)
        head = torch.from_numpy(np.stack(self.pool[0][:16])).to(self.device)
        self.calibration = weights.calibrate(self.cfg, self.wts, head, self.device)

    def checked_clip(self) -> int:
        """The window's clip the check judges, its first or second, drawn
        from the seed. Window clip i runs pool clip (i + 1) % len(pool)."""
        return int(np.random.default_rng(self.seed).integers(2))

    def setup(self, tmp: Path) -> None:
        self.prepare()
        self.trackers = _trackers(self.cfg, self.hw, self.wts, tmp, self.device)
        self.tmp = tmp
        from padel_analytics_tpu_torch.trackers.runner import TrackingRunner

        c = self.cfg
        self.runner = TrackingRunner(
            self.trackers, self._clip(0), tmp / "unused.mp4", fused=True,
            fused_chunk=c["fused_chunk"], fused_ingest=c["ingest"], collect_data=True,
            render=False)
        # Warm-up: every shape and buffer the window uses, on the clip the
        # window does not start with, so that its first clip, as every
        # other, finds the ball's median computed for another clip.
        self.clip(0)
        gc.collect()

    def _clip(self, k: int):
        from padel_analytics_tpu_torch.utils.video import MemoryClip

        return MemoryClip(self.pool[k], self.traffic["fps"])

    def clip(self, k: int) -> tuple[float, float]:
        """One job: the runner handed pool clip `k` (every clip of the pool
        has the same size, rate and length), `restart()`, `run()`, then
        data.csv. Returns (the clip's seconds, the collect pass's seconds,
        write_csv included)."""
        from padel_analytics_tpu_torch.trackers.runner import FrameStore

        runner = self.runner
        t0 = time.perf_counter()
        runner.frame_store = FrameStore(self._clip(k), runner.start, runner.stride, runner.end)
        runner.restart()
        runner.run()
        t1 = time.perf_counter()
        runner.write_csv(self.tmp / "data.csv")
        t2 = time.perf_counter()
        return t2 - t0, runner.stage_times.get("draw_and_collect", 0.0) + (t2 - t1)

    def _keep(self) -> dict:
        """The files of the clip just run: its caches and data.csv."""
        names = ["players", "pose", "ball", "court", "data"]
        return {k: (self.tmp / (f"{k}.csv" if k == "data" else f"{k}.json")).read_text()
                for k in names}

    def window(self, seconds: float, traced: bool, rec: Record) -> dict:
        """The measured window; returns the files of the clip the check
        judges (`checked_clip`)."""
        want = self.checked_clip()
        kept = {}
        start = time.perf_counter()
        i = 0
        while True:
            k = (i + 1) % len(self.pool)
            if traced and i == 0:
                from torch.profiler import ProfilerActivity, profile

                with trace.K1Recorder(PACKAGE) as k1, profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    s, collect_s = self.clip(k)
                    torch.cuda.synchronize()
                rec.k1_calls = k1.calls
                rec.profile = (prof, s)
            else:
                s, collect_s = self.clip(k)
            rec.clips.append({"frames": self.n, "seconds": s, "collect_s": collect_s,
                              "traced": traced and i == 0})
            if i == want:
                kept = self._keep()
            i += 1
            # At least the two clips the check draws from; a traced run
            # also reads its per-frame rates from the clips after the first.
            if time.perf_counter() - start >= seconds and i >= 2:
                break
        self.window_s = time.perf_counter() - start
        return kept

    def check(self, kept: dict) -> dict:
        """The compared numbers of the kept clip against the reference."""
        from .reference.pipeline import ReferencePipeline

        frames = self.pool[(self.checked_clip() + 1) % len(self.pool)]
        got = check.parse_caches(kept, len(frames))
        if self.cfg["court"]["mode"] == "fixed":
            got.court = []
        ref = ReferencePipeline(self.cfg, self.wts, self.hw, self.device).run(
            torch.from_numpy(np.stack(frames)).to(self.device))
        nums, self.check_basis = check.numbers(got, ref, self.cfg, self.hw)
        nums["csv_rows"] = check.csv_rows(kept["data"], check.player_ids(kept["players"]))
        return nums

    def free_program(self) -> None:
        del self.trackers, self.runner
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metrics(names: list[str], rec: Record) -> dict:
    """Each per-layer metric by its reader (metrics/<name>.py); a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for name in names:
        value = importlib.import_module(f"benchmark.metrics.{name}").read(rec)
        if value is not None:
            out[name] = value
    return out


def run(manifest: Manifest, workload: str, seed: int, seconds: float, traced: bool,
        t_process: float, device: str = "cuda") -> tuple[dict, dict]:
    """One run; returns (the result line, the compared numbers with their
    limits)."""
    cell = Cell(manifest, workload, seed, device)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        cell.setup(Path(tmp))
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_process
        rec = Record()
        kept = cell.window(seconds, traced, rec)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if traced:
            rec.trace = trace.read_profile(*rec.profile)
            rec.profile = None
        rec.flops_per_frame = flops.flops_per_frame(cell.cfg, cell.hw)
        attempted = len(rec.clips)
        frames = sum(c["frames"] for c in rec.clips)
        cell.free_program()
        t_check = time.perf_counter()
        nums = cell.check(kept)
        check_s = time.perf_counter() - t_check
    compared = check.report(nums, cell.limits)
    result = {"correct": check.verdict(nums, cell.limits), "attempted": attempted, "failed": 0}
    if traced:
        metrics = read_metrics(manifest.per_layer_for(workload), rec)
        units = manifest.units()
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()}
    else:
        result["metrics"] = {
            "fps": {"value": frames / cell.window_s, "unit": "frames/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name() if device == "cuda" else device,
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = trace.breakdown(rec.trace)
    result["device"] = dev
    result["phases_s"] = {"setup": setup_s, "window": cell.window_s, "check": check_s,
                          "clips": [c["seconds"] for c in rec.clips]}
    result["calibration"] = cell.calibration
    result["check_basis"] = cell.check_basis
    result["compared"] = compared
    return result, compared
