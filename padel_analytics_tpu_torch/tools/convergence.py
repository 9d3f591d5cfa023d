"""TrackNet convergence demo on a synthetic rally: decoded ball positions
converge to the ground truth, not merely the loss.

Counterpart of the JAX package's ``tools/convergence_demo.py``: the real
TrackNet architecture trained at 48x80 (seq_len 8, 'concat') on an in-memory
rally drawn with OpenCV, evaluated against the truth before and after. The
evaluation serves the model in the serving dtype and decodes with
``ops.heatmap.decode_heatmaps``: on the card that is kernels K1 (bf16) and
K2; on the CPU their plain versions in fp32.

    python -m padel_analytics_tpu_torch.tools.convergence [--steps 80] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from itertools import islice
from typing import Iterator, Optional

import numpy as np
import torch

from ..models.layers import truncated_lecun_normal_
from ..models.tracknet import make_tracknet
from ..ops.heatmap import decode_heatmaps
from ..training.data import RallyClip, window_batches
from ..training.state import TrainState, init_train_state
from ..training.tracknet import make_tracknet_train_step
from ._common import (
    StepTimer,
    device_argument,
    model_device,
    require_cv2,
    resolve_device,
    serving_dtype,
)


def make_rally(n: int, h: int, w: int, rng: np.random.Generator) -> RallyClip:
    """Synthetic rally at model resolution: a bright ball on a noisy
    court-like background along a smooth trajectory (the JAX demo's pixels,
    drawn with the same cv2 calls and `rng` draws)."""
    cv2 = require_cv2()
    frames = np.zeros((n, h, w, 3), np.uint8)
    coords = np.zeros((n, 2), np.float32)
    t = np.linspace(0, 3 * np.pi, n)
    xs = (w * 0.12) + (w * 0.76) * (0.5 + 0.5 * np.sin(t))
    ys = (h * 0.25) + (h * 0.5) * (0.5 + 0.5 * np.sin(2.3 * t + 1.0))
    for i in range(n):
        f = np.full((h, w, 3), 45, np.uint8)
        cv2.rectangle(f, (w // 10, h // 8), (w - w // 10, h - h // 8), (80, 120, 80), 1)
        f += rng.integers(0, 8, f.shape, dtype=np.uint8)
        cv2.circle(f, (int(xs[i]), int(ys[i])), 2, (250, 250, 120), -1)
        frames[i] = f
        coords[i] = (int(xs[i]), int(ys[i]))
    median = np.median(frames, axis=0).astype(np.uint8)
    return RallyClip(frames=frames, coords=np.trunc(coords), visibility=np.ones(n, np.float32),
                     median=median, coords_src=coords)


def decode_positions(model: torch.nn.Module, clip: RallyClip,
                     seq_len: int) -> tuple[np.ndarray, np.ndarray]:
    """The model over the clip's stride-seq_len windows, one window a call,
    in eval mode and the serving dtype of its device; each frame's heatmap
    decoded. Returns (frame indices, (N_eval, 2) float positions, -1 where
    no blob cleared the threshold)."""
    dev = model_device(model)
    dtype = serving_dtype(dev)
    n = clip.frames.shape[0]
    med = clip.median.astype(np.float32)
    idxs, outs = [], []
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for lo in range(0, n - seq_len + 1, seq_len):
                window = clip.frames[lo: lo + seq_len].astype(np.float32)
                x = np.concatenate([med] + [window[j] for j in range(seq_len)], axis=-1)[None] / 255.0
                y = model(torch.from_numpy(x).to(dev, dtype))  # (1, H, W, L)
                cx, cy, vis = (t.cpu().numpy() for t in decode_heatmaps(y.permute(0, 3, 1, 2)[0]))
                for j in range(seq_len):
                    idxs.append(lo + j)
                    outs.append((float(cx[j]), float(cy[j])) if int(vis[j]) else (-1.0, -1.0))
    finally:
        model.train(was_training)
    return np.asarray(idxs), np.asarray(outs, np.float32)


def evaluate(model: torch.nn.Module, clip: RallyClip, seq_len: int) -> dict:
    """detect_rate, within_4px and mean_px of the decoded positions against
    the clip's truncated truth."""
    idxs, pred = decode_positions(model, clip, seq_len)
    gt = clip.coords[idxs]
    found = pred[:, 0] >= 0
    dist = np.full(len(idxs), np.inf)
    dist[found] = np.hypot(pred[found, 0] - gt[found, 0], pred[found, 1] - gt[found, 1])
    return {
        "detect_rate": float(found.mean()),
        "within_4px": float((dist <= 4.0).mean()),
        "mean_px": float(dist[np.isfinite(dist)].mean()) if found.any() else float("inf"),
    }


def new_tracknet(seq_len: int, device, init: Optional[dict] = None,
                 lr: float = 2e-3) -> TrainState:
    """A 'concat' TrackNet in train mode on `device` with Adam: from `init`
    (a state_dict, e.g. the JAX demo's initial variables converted) or
    Flax's truncated LeCun normal (the JAX demo's init) drawn from seed 0."""
    model, _ = make_tracknet(seq_len, "concat")
    if init is None:
        truncated_lecun_normal_(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(init)
    return init_train_state(model.to(device), lr)


def tracknet_batches(clip: RallyClip, seq_len: int, batch: int, rng: np.random.Generator,
                     device) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """The training batches forever: epoch after epoch of the clip's
    shuffled stride-1 windows (`window_batches`, one permutation of `rng`
    an epoch), made on `device`."""
    while True:
        yield from window_batches(clip, seq_len=seq_len, batch_size=batch, rng=rng,
                                  device=device)


def train_tracknet(state: TrainState, clip: RallyClip, steps: int, batch: int, seq_len: int,
                   rng: np.random.Generator, verbose: bool = False) -> tuple[list, StepTimer]:
    """`steps` Adam steps over `tracknet_batches`; returns (losses, timer)."""
    step_fn = make_tracknet_train_step()
    dev = model_device(state.model)
    losses, timer = [], StepTimer()
    for x, labels in islice(tracknet_batches(clip, seq_len, batch, rng, dev), steps):
        timer.start()
        state, loss = step_fn(state, x, labels)
        losses.append(float(loss))
        timer.stop()
        if verbose and len(losses) % 10 == 0:
            print(f"step {len(losses)}: loss {losses[-1]:.5f}", flush=True)
    return losses, timer


def run_demo(steps: int = 80, h: int = 48, w: int = 80, n: int = 72, batch: int = 4,
             seq_len: int = 8, lr: float = 2e-3, verbose: bool = True, device="cuda",
             init: Optional[dict] = None) -> dict:
    """Train from `init` (or the seeded start) for `steps` steps; returns
    {"before", "after", "losses", "step_ms", "wall_s", "model", "clip"}."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    clip = make_rally(n, h, w, rng)
    state = new_tracknet(seq_len, dev, init, lr)
    before = evaluate(state.model, clip, seq_len)
    if verbose:
        print(f"before training: {before}", flush=True)
    losses, timer = train_tracknet(state, clip, steps, batch, seq_len, rng, verbose)
    after = evaluate(state.model, clip, seq_len)
    if verbose:
        print(f"after {len(losses)} steps: {after}", flush=True)
        print(f"loss: first-5 mean {np.mean(losses[:5]):.5f} -> "
              f"last-5 mean {np.mean(losses[-5:]):.5f}", flush=True)
    return {"before": before, "after": after, "losses": losses, "step_ms": timer.median_ms(),
            "wall_s": time.perf_counter() - t0, "model": state.model, "clip": clip}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--h", type=int, default=48)
    ap.add_argument("--w", type=int, default=80)
    ap.add_argument("--frames", type=int, default=72)
    device_argument(ap)
    args = ap.parse_args(argv)
    out = run_demo(steps=args.steps, h=args.h, w=args.w, n=args.frames, device=args.device)
    ok = out["after"]["within_4px"] >= 0.8
    print(f"convergence: {'OK' if ok else 'NOT CONVERGED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
