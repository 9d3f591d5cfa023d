"""InpaintNet convergence demo: gap-filling error in pixels on a held-out
rally.

Counterpart of the JAX package's ``tools/inpaint_convergence_demo.py``:
InpaintNet (the reference's coordinate mode) trained over 16 synthesized
rallies, sweep after sweep, with `rng` drawn in the JAX demo's order; the
mean pixel error on the masked (inpainted) positions of an unseen rally
before and after, at 1280x720. InpaintNet holds no 2-D conv: no kernel of
the port runs here. It is served in the serving dtype of its device (bf16
on the card, fp32 on the CPU), as BallTracker serves it.

    python -m padel_analytics_tpu_torch.tools.inpaint_convergence [--steps 1200]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..models.layers import truncated_lecun_normal_
from ..models.tracknet import InpaintNet
from ..training.data import InpaintRally, coordinate_window_batches, synthesize_inpaint_rally
from ..training.inpaintnet import make_inpaintnet_train_step
from ..training.state import init_train_state
from ._common import StepTimer, device_argument, model_device, resolve_device, serving_dtype

IMG_WH = (1280, 720)
SEQ_LEN = 16


def make_trajectory(rng: np.random.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
    """A smooth rally-like 2-D trajectory in source pixels and full
    visibility; frequency, amplitude and phase drawn per rally, so that a
    training set spans the family instead of one memorizable curve."""
    w, h = IMG_WH
    t = np.linspace(0, rng.uniform(3, 5) * np.pi, n)
    fx, fy = rng.uniform(0.8, 1.2), rng.uniform(1.4, 2.0)
    ax, ay = rng.uniform(0.25, 0.4), rng.uniform(0.2, 0.32)
    x = w * (0.5 + ax * np.sin(fx * t + rng.uniform(0, 2 * np.pi)))
    y = h * (0.45 + ay * np.sin(fy * t + rng.uniform(0, 2 * np.pi)))
    return np.stack([x, y], axis=-1).astype(np.float32), np.ones(n, np.float32)


def make_rallies(n: int) -> tuple[list[InpaintRally], InpaintRally, np.random.Generator]:
    """(the 16 training rallies drawn from rng 0, the held-out rally from rng
    7 at n // 2 frames, rng 0 as the training loop goes on drawing from it)."""
    rng = np.random.default_rng(0)
    train = []
    for _ in range(16):
        coords, vis = make_trajectory(rng, n)
        train.append(synthesize_inpaint_rally(coords, vis, IMG_WH, rng, max_gap=6))
    ev_rng = np.random.default_rng(7)
    ev_coords, ev_vis = make_trajectory(ev_rng, n // 2)
    return train, synthesize_inpaint_rally(ev_coords, ev_vis, IMG_WH, ev_rng, max_gap=6), rng


def masked_px_error(model: torch.nn.Module, rally: InpaintRally) -> float:
    """Mean pixel error of the model's outputs on the inpainted positions
    over all stride-SEQ_LEN windows of a rally (batches of 4, which divide
    the held-out rally's 12 windows)."""
    dev = model_device(model)
    dtype = serving_dtype(dev)
    errs = []
    scale = np.asarray(rally.img_wh, np.float32)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for coords, mask, target in coordinate_window_batches(
                    rally, seq_len=SEQ_LEN, batch_size=4, sliding_step=SEQ_LEN, device=dev):
                pred = model(coords, mask, dtype=dtype)
                d = (pred - target).cpu().numpy() * scale
                m = mask.cpu().numpy()[..., 0] > 0
                if m.any():
                    errs.append(np.hypot(d[..., 0], d[..., 1])[m])
    finally:
        model.train(was_training)
    return float(np.concatenate(errs).mean()) if errs else float("nan")


def inpaint_batches(rallies: list[InpaintRally], rng: np.random.Generator,
                    device) -> Iterator[tuple[torch.Tensor, ...]]:
    """The training batches forever: one full sweep of batch-8,
    sliding-step-4 windows per rally, the rallies in turn (a sweep counter,
    not the step, picks the rally)."""
    sweep = 0
    while True:
        rally = rallies[sweep % len(rallies)]
        sweep += 1
        yield from coordinate_window_batches(rally, seq_len=SEQ_LEN, batch_size=8, rng=rng,
                                             sliding_step=4, device=device)


def run_demo(steps: int = 400, n: int = 400, lr: float = 2e-3, verbose: bool = True,
             device="cuda", init: Optional[dict] = None) -> dict:
    """Returns {"before_px", "after_px", "losses", "step_ms", "wall_s",
    "model", "eval_rally"}."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    train_rallies, eval_rally, rng = make_rallies(n)
    model = InpaintNet()
    if init is None:
        truncated_lecun_normal_(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(init)
    state = init_train_state(model.to(dev), lr)
    step_fn = make_inpaintnet_train_step()

    before = masked_px_error(state.model, eval_rally)
    if verbose:
        print(f"before training: masked px error {before:.1f}", flush=True)
    losses, timer = [], StepTimer()
    batches = inpaint_batches(train_rallies, rng, dev)
    while len(losses) < steps:
        coords_b, mask_b, target_b = next(batches)
        timer.start()
        state, loss = step_fn(state, coords_b, mask_b, target_b)
        losses.append(float(loss))
        timer.stop()
        if verbose and len(losses) % 50 == 0:
            print(f"step {len(losses)}: loss {losses[-1]:.6f}", flush=True)
    after = masked_px_error(state.model, eval_rally)
    if verbose:
        print(f"after {len(losses)} steps: masked px error {after:.1f}", flush=True)
    return {"before_px": before, "after_px": after, "losses": losses,
            "step_ms": timer.median_ms(), "wall_s": time.perf_counter() - t0,
            "model": state.model, "eval_rally": eval_rally}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1200)
    device_argument(ap)
    args = ap.parse_args(argv)
    out = run_demo(steps=args.steps, device=args.device)
    ok = out["after_px"] < 100.0 and out["after_px"] < out["before_px"] / 3.5
    print(f"convergence: {'OK' if ok else 'NOT CONVERGED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
