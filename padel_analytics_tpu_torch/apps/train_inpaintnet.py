"""InpaintNet training CLI.

Counterpart of ``padel_analytics_tpu/apps/train_inpaintnet.py``: trains
the trajectory-inpainting model on coordinate windows of the reference's
'coordinate' layout (<match_dir>/predicted_csv/<rally_id>_ball.csv with
TrackNet's predictions, the ground truth and an Inpaint_Mask column), or,
with --synthetic-gaps, from the ground-truth ball CSVs with drop-out gaps
made up (training/data.synthesize_inpaint_rally). Writes the reference's
checkpoint format, which `BallTrackerConfig(inpainting_model_path=...)`
loads.

  python -m padel_analytics_tpu_torch.apps.train_inpaintnet \\
      --match-dir data/match1 --rallies 1_00_01 1_02_05 \\
      --epochs 3 --batch 32 --out weights/inpaintnet.pt \\
      [--synthetic-gaps --img-wh 1920 1080] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import sys
import time
from pathlib import Path

import numpy as np


def _load_gt_rally(match_dir: str, rally_id: str):
    """The ground-truth (Frame, X, Y, Visibility) CSV, reused for
    synthetic-gap training."""
    with open(Path(match_dir) / "csv" / f"{rally_id}_ball.csv") as f:
        rows = sorted(csv.DictReader(f), key=lambda r: int(r["Frame"]))
    coords = np.asarray([(float(r["X"] or 0), float(r["Y"] or 0)) for r in rows], np.float32)
    vis = np.asarray([float(r["Visibility"] or 0) for r in rows], np.float32)
    return coords, vis


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="train_inpaintnet")
    parser.add_argument("--match-dir", required=True)
    parser.add_argument("--rallies", nargs="+", required=True)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seq-len", type=int, default=16)
    parser.add_argument("--sliding-step", type=int, default=1)
    parser.add_argument("--synthetic-gaps", action="store_true",
                        help="train from ground-truth CSVs with synthesized drop-out gaps "
                        "instead of a predicted_csv directory")
    parser.add_argument("--img-wh", type=int, nargs=2, default=None,
                        help="source resolution (w h) for coordinate normalization; "
                        "inferred from frame images when omitted")
    parser.add_argument("--out", default="inpaintnet.pt",
                        help="a .pt file, or .msgpack for the JAX package's Flax format")
    parser.add_argument("--resume", default=None)
    from ._train import add_device_args

    add_device_args(parser)
    args = parser.parse_args(argv)

    from ..models.tracknet import InpaintNet
    from ..training.checkpoint import load_for_resume, save_inpaintnet
    from ..training.data import (
        coordinate_window_batches,
        load_inpaint_rally,
        synthesize_inpaint_rally,
    )
    from ..training.inpaintnet import make_inpaintnet_train_step
    from ..training.state import init_train_state
    from ._train import init_weights, log, mean_loss, place, save_on_main, setup, shard

    device, mesh = setup(args)
    model = init_weights(InpaintNet())
    if args.resume:
        model.load_state_dict(load_for_resume("inpaintnet", args.resume))
    state = init_train_state(place(model, mesh, device), args.lr)
    log(mesh, f"train: device {device}")

    img_wh = tuple(args.img_wh) if args.img_wh else None
    rng = np.random.default_rng(0)
    rallies = []
    for rid in args.rallies:
        if args.synthetic_gaps:
            if img_wh is None:
                raise SystemExit("--synthetic-gaps needs --img-wh w h")
            coords, vis = _load_gt_rally(args.match_dir, rid)
            rallies.append(synthesize_inpaint_rally(coords, vis, img_wh, rng))
        else:
            rallies.append(load_inpaint_rally(args.match_dir, rid, img_wh))
    log(mesh, f"train: {len(rallies)} rallies, "
              f"{sum(r.coords_pred.shape[0] for r in rallies)} frames, "
              f"{sum(int(r.inpaint_mask.sum()) for r in rallies)} masked")

    step_fn = make_inpaintnet_train_step(mesh)
    rows = shard(args.batch, mesh)
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for rally in rallies:
            for coords, mask, target in coordinate_window_batches(
                    rally, seq_len=args.seq_len, batch_size=args.batch, rng=rng,
                    sliding_step=args.sliding_step, device=device):
                state, loss = step_fn(state, coords[rows], mask[rows], target[rows])
                losses.append(loss)
        log(mesh, f"epoch {epoch}: loss {mean_loss(losses):.6f} "
                  f"({len(losses)} steps, {time.perf_counter() - t0:.1f}s)")

    save_on_main(mesh, state.model, lambda m: save_inpaintnet(args.out, m, args.seq_len))
    log(mesh, f"train: wrote {args.out} after {state.step} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
