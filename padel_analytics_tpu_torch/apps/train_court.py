"""ResNet court-keypoint regression training CLI.

Counterpart of ``padel_analytics_tpu/apps/train_court.py``. Dataset: an
images directory and one JSON mapping image filename -> [[x, y], ...]
court keypoints in source pixels (the keypoint picker's output); targets
are normalised by each image's own size. Writes torchvision resnet50 names,
which `KeypointsTracker(model_type="resnet", model_path=...)` loads.

  python -m padel_analytics_tpu_torch.apps.train_court \\
      --images data/frames --keypoints data/court_keypoints.json \\
      --epochs 5 --batch 8 --out weights/court.pt \\
      [--resume weights/court_resnet.pt] [--stage-sizes 3,4,6,3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def load_dataset(images_dir: str, keypoints_json: str):
    """(paths, kpts_px (N, K, 2)) for the images the JSON names."""
    table = json.loads(Path(keypoints_json).read_text())
    paths, rows = [], []
    for p in sorted(Path(images_dir).iterdir()):
        if p.name in table:
            kp = np.asarray(table[p.name], np.float32)
            if kp.ndim != 2 or kp.shape[1] != 2:
                raise ValueError(f"{p.name}: keypoints must be (K, 2)")
            paths.append(p)
            rows.append(kp)
    if not paths:
        raise FileNotFoundError(f"no {images_dir} images named in {keypoints_json}")
    ks = {r.shape[0] for r in rows}
    if len(ks) != 1:
        raise ValueError(f"inconsistent keypoint counts across images: {ks}")
    return paths, np.stack(rows)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="train_court")
    parser.add_argument("--images", required=True)
    parser.add_argument("--keypoints", required=True)
    parser.add_argument("--imgsz", type=int, default=224)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", default="court.pt",
                        help="a .pt file, or .msgpack for the JAX package's Flax format")
    parser.add_argument("--resume", default=None)
    # test-sized stages; the default is the real ResNet-50
    parser.add_argument("--stage-sizes", default="3,4,6,3")
    from ._train import add_device_args

    add_device_args(parser)
    args = parser.parse_args(argv)

    import torch

    from ..models.resnet import ResNet50Regressor, imagenet_normalize
    from ..training.checkpoint import load_for_resume, save_resnet
    from ..training.data import load_image_bicubic01
    from ..training.resnet_court import make_court_train_step, normalize_court_targets
    from ..training.state import init_train_state
    from ._train import init_weights, log, mean_loss, place, save_on_main, setup, shard

    device, mesh = setup(args)
    paths, kpts_px = load_dataset(args.images, args.keypoints)
    n_kp = kpts_px.shape[1]
    log(mesh, f"train_court: {len(paths)} images, {n_kp} keypoints, device {device}")

    hw = (args.imgsz, args.imgsz)
    stage_sizes = tuple(int(v) for v in args.stage_sizes.split(","))
    model = init_weights(ResNet50Regressor(num_outputs=2 * n_kp, stage_sizes=stage_sizes))
    if args.resume:
        model.load_state_dict(load_for_resume("resnet", args.resume))
    state = init_train_state(place(model, mesh, device), args.lr)
    step = make_court_train_step(mesh)

    rng = np.random.default_rng(0)
    # Clamp the batch to the dataset (a smaller dataset would otherwise train
    # zero steps and save untrained weights).
    b = min(args.batch, len(paths))
    rows = shard(b, mesh)
    if len(paths) % b:
        log(mesh, f"train_court: dropping {len(paths) % b} remainder images/epoch")
    for epoch in range(args.epochs):
        order = rng.permutation(len(paths))
        t0 = time.perf_counter()
        losses = []
        for lo in range(0, len(order) - b + 1, b):
            imgs, targets = [], []
            for i in order[lo: lo + b][rows]:
                img01, wh = load_image_bicubic01(paths[i], hw, device)
                imgs.append(img01)
                targets.append(normalize_court_targets(kpts_px[i], wh))
            images = imagenet_normalize(torch.from_numpy(np.stack(imgs)).to(device))
            state, loss = step(state, images, torch.stack(targets).to(device))
            losses.append(loss)
        log(mesh, f"epoch {epoch}: loss {mean_loss(losses):.5f} "
                  f"({time.perf_counter() - t0:.1f}s)")

    save_on_main(mesh, state.model, lambda m: save_resnet(args.out, m))
    log(mesh, f"train_court: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
