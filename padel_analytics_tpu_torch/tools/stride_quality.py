"""The nonoverlap ball mode's quality trade on a TRAINED TrackNet.

Counterpart of the JAX package's ``tools/stride_quality_demo.py``: TrackNet
is trained on a synthetic rally as in `convergence`, then the same weights
run through the port's BallTracker end to end twice, at window stride 1
(the reference's rolling ensemble) and at window stride seq_len (the
nonoverlap mode), with detect rate, within-4px and mean px against the
truth for both. The tracker runs in the serving dtype (bf16 through K1 and
K2 on the card, fp32 on the CPU), without the median-buffer channel quirk
(the model is trained on RGB) and without InpaintNet.

    python -m padel_analytics_tpu_torch.tools.stride_quality [--steps 80] [--frames 160]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..config import BallTrackerConfig
from ..trackers.ball import BallTracker
from ..training.data import RallyClip
from ..utils.video import VideoInfo
from ._common import device_argument, model_device, resolve_device, serving_dtype
from .convergence import make_rally, new_tracknet, train_tracknet


def _tracker_eval(clip: RallyClip, model: torch.nn.Module, stride: int, seq_len: int,
                  h: int, w: int) -> dict:
    """`model`'s weights through BallTracker on its device at window
    `stride`; detect_rate, within_4px and mean_px against the truth."""
    dev = model_device(model)
    n = clip.frames.shape[0]
    cfg = BallTrackerConfig(height=h, width=w, batch_size=8, median_max_sample_num=min(n, 64),
                            seq_len=seq_len, window_stride=stride)
    tr = BallTracker(None, None, config=cfg, compute_dtype=serving_dtype(dev),
                     channel_quirk=False, device=dev)
    tr.tracknet.model.load_state_dict(model.state_dict())
    tr.video_info_post_init(VideoInfo(width=w, height=h, fps=30.0, total_frames=n))
    balls = tr.predict_frames(iter([f for f in clip.frames]), n)
    pred = np.asarray([[b.xy[0], b.xy[1]] for b in balls], np.float32)
    vis = np.asarray([b.visibility for b in balls], bool)
    gt = clip.coords[: len(balls)]
    dist = np.full(len(balls), np.inf)
    dist[vis] = np.hypot(pred[vis, 0] - gt[vis, 0], pred[vis, 1] - gt[vis, 1])
    return {
        "detect_rate": float(vis.mean()),
        "within_4px": float((dist <= 4.0).mean()),
        "mean_px": float(dist[np.isfinite(dist)].mean()) if vis.any() else float("inf"),
    }


def run_demo(steps: int = 80, h: int = 48, w: int = 80, n: int = 160, batch: int = 4,
             seq_len: int = 8, lr: float = 2e-3, verbose: bool = True, device="cuda",
             init: Optional[dict] = None) -> dict:
    """Train, then serve at both strides; returns {"stride1", "nonoverlap",
    "losses", "step_ms", "wall_s", "model", "clip"}."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    clip = make_rally(n, h, w, rng)
    state = new_tracknet(seq_len, dev, init, lr)
    losses, timer = train_tracknet(state, clip, steps, batch, seq_len, rng)
    r1 = _tracker_eval(clip, state.model, 1, seq_len, h, w)
    r8 = _tracker_eval(clip, state.model, seq_len, seq_len, h, w)
    if verbose:
        print(f"stride-1 ensemble : {r1}", flush=True)
        print(f"stride-{seq_len} nonoverlap: {r8}", flush=True)
    return {"stride1": r1, "nonoverlap": r8, "losses": losses, "step_ms": timer.median_ms(),
            "wall_s": time.perf_counter() - t0, "model": state.model, "clip": clip}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--frames", type=int, default=160)
    device_argument(ap)
    args = ap.parse_args(argv)
    run_demo(steps=args.steps, n=args.frames, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
