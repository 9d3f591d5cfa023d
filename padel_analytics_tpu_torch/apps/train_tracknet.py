"""TrackNet training CLI.

Counterpart of ``padel_analytics_tpu/apps/train_tracknet.py``: trains on
the reference's rally-directory layout (training/data.py) and writes the
reference's checkpoint format, which `BallTracker(tracking_model_path=...)`
loads.

  python -m padel_analytics_tpu_torch.apps.train_tracknet \\
      --match-dir data/match1 --rallies 1_00_01 1_02_05 \\
      --epochs 3 --batch 8 --out weights/tracknet.pt \\
      [--mixup 0.5] [--resume tracknet.pt] [--device cpu]

On N cards: torchrun --nproc-per-node=N -m ... --data-parallel N (each
rank takes its shard of every global batch of --batch windows); with
--model-parallel M over N = D x M processes, the wide convs' output
channels split over M neighbouring ranks and the batch over D.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="train_tracknet")
    parser.add_argument("--match-dir", required=True)
    parser.add_argument("--rallies", nargs="+", required=True)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seq-len", type=int, default=8)
    parser.add_argument("--height", type=int, default=288)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--mixup", type=float, default=0.0)
    parser.add_argument("--out", default="tracknet.pt",
                        help="a .pt file, or .msgpack for the JAX package's Flax format")
    parser.add_argument("--resume", default=None)
    from ._train import add_device_args

    add_device_args(parser)
    args = parser.parse_args(argv)

    from ..models.tracknet import make_tracknet
    from ..training.checkpoint import load_for_resume, save_tracknet
    from ..training.data import load_rally, window_batches
    from ..training.state import init_train_state
    from ..training.tracknet import make_tracknet_train_step
    from ._train import init_weights, log, mean_loss, place, save_on_main, setup, shard

    device, mesh = setup(args)
    model, _ = make_tracknet(args.seq_len, "concat")
    init_weights(model)
    if args.resume:
        model.load_state_dict(load_for_resume("tracknet", args.resume))
    state = init_train_state(place(model, mesh, device), args.lr)
    log(mesh, f"train: device {device}")

    clips = [load_rally(args.match_dir, rid, args.height, args.width, device=device)
             for rid in args.rallies]
    log(mesh, f"train: {len(clips)} rallies, {sum(c.frames.shape[0] for c in clips)} frames")

    step_fn = make_tracknet_train_step(mesh)
    rows = shard(args.batch, mesh)
    rng = np.random.default_rng(0)
    mixup_rng = np.random.default_rng([0, 1])
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for clip in clips:
            for x, labels in window_batches(clip, seq_len=args.seq_len, batch_size=args.batch,
                                            rng=rng, mixup_alpha=args.mixup,
                                            mixup_rng=mixup_rng, device=device):
                state, loss = step_fn(state, x[rows], labels[rows])
                losses.append(loss)
        log(mesh, f"epoch {epoch}: loss {mean_loss(losses):.5f} "
                  f"({len(losses)} steps, {time.perf_counter() - t0:.1f}s)")

    save_on_main(mesh, state.model,
                 lambda m: save_tracknet(args.out, m, args.seq_len, "concat"))
    log(mesh, f"train: wrote {args.out} after {state.step} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
