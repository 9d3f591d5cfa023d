"""YOLOv8 detection / pose training CLI.

Counterpart of ``padel_analytics_tpu/apps/train_yolo.py``. Trains on the
ultralytics dataset layout: an images directory and a labels directory of
one .txt per image, each line `class cx cy w h [kx ky kv ...]` normalised
to [0, 1]. Writes ultralytics' state_dict names, which the port's players,
pose and yolo-court trackers load.

  python -m padel_analytics_tpu_torch.apps.train_yolo \\
      --images data/images --labels data/labels --imgsz 640 \\
      --variant n --epochs 5 --batch 8 --out weights/det.pt \\
      [--keypoints 13] [--resume weights/yolov8n.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def load_dataset(images_dir: str, labels_dir: str, max_gt: int):
    """(paths, labels (N, max_gt), boxes_norm (N, max_gt, 4) cxcywh,
    kpts_norm (N, max_gt, K, 3) or None, mask (N, max_gt))."""
    paths = sorted(p for p in Path(images_dir).iterdir() if p.suffix.lower() in IMAGE_EXTS)
    if not paths:
        raise FileNotFoundError(f"no images in {images_dir}")
    rows = []
    nk = 0
    for p in paths:
        lp = Path(labels_dir) / (p.stem + ".txt")
        entries = []
        if lp.exists():
            for line in lp.read_text().splitlines():
                vals = [float(v) for v in line.split()]
                if len(vals) >= 5:
                    entries.append(vals)
                    nk = max(nk, (len(vals) - 5) // 3)
        rows.append(entries)
    n = len(paths)
    labels = np.zeros((n, max_gt), np.int32)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    kpts = np.zeros((n, max_gt, nk, 3), np.float32) if nk else None
    mask = np.zeros((n, max_gt), bool)
    for i, entries in enumerate(rows):
        for j, vals in enumerate(entries[:max_gt]):
            labels[i, j] = int(vals[0])
            boxes[i, j] = vals[1:5]
            if nk:
                k = np.asarray(vals[5: 5 + nk * 3], np.float32)
                kpts[i, j, : len(k) // 3] = k.reshape(-1, 3)
            mask[i, j] = True
    return paths, labels, boxes, kpts, mask


def cxcywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    return np.stack([b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                     b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2],
                    axis=-1).astype(np.float32)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="train_yolo")
    parser.add_argument("--images", required=True)
    parser.add_argument("--labels", required=True)
    parser.add_argument("--imgsz", type=int, default=640)
    parser.add_argument("--variant", default="n")
    parser.add_argument("--classes", type=int, default=1)
    parser.add_argument("--keypoints", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--max-gt", type=int, default=16)
    parser.add_argument("--out", default="yolo.pt",
                        help="a .pt file, or .msgpack for the JAX package's Flax format")
    parser.add_argument("--resume", default=None)
    from ._train import add_device_args

    add_device_args(parser)
    args = parser.parse_args(argv)

    import torch

    from ..models.yolov8 import YOLOv8
    from ..training.checkpoint import load_for_resume, save_yolov8
    from ..training.data import load_image_bicubic01
    from ..training.state import init_train_state
    from ..training.yolo import make_yolo_train_step
    from ._train import init_weights, log, mean_loss, place, save_on_main, setup, shard

    device, mesh = setup(args)
    pose = args.keypoints > 0
    hw = (args.imgsz, args.imgsz)
    model = init_weights(YOLOv8(args.variant, args.classes, args.keypoints))
    if args.resume:
        model.load_state_dict(load_for_resume("yolo", args.resume))
    state = init_train_state(place(model, mesh, device), args.lr)
    step = make_yolo_train_step(pose=pose, mesh=mesh)

    paths, labels, boxes_n, kpts_n, mask = load_dataset(args.images, args.labels, args.max_gt)
    log(mesh, f"train_yolo: {len(paths)} images, pose={pose}, device {device}")
    if pose and kpts_n is None:
        raise ValueError(f"--keypoints {args.keypoints} but no label file carries keypoint "
                         "triplets (lines must be 'class cx cy w h kx ky kv ...')")
    if pose and kpts_n.shape[2] != args.keypoints:
        raise ValueError(f"--keypoints {args.keypoints} but labels carry "
                         f"{kpts_n.shape[2]} keypoints per instance")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rng = np.random.default_rng(0)
    # Clamp the batch to the dataset (a smaller dataset would otherwise train
    # zero steps and save untrained weights); each epoch drops a remainder
    # smaller than the batch, as the JAX app's fixed batch shape does.
    b = min(args.batch, len(paths))
    rows = shard(b, mesh)
    if len(paths) % b:
        log(mesh, f"train_yolo: dropping {len(paths) % b} remainder images/epoch")
    s = args.imgsz
    for epoch in range(args.epochs):
        order = rng.permutation(len(paths))
        t0 = time.perf_counter()
        losses = []
        for lo in range(0, len(order) - b + 1, b):
            idx = order[lo: lo + b][rows]
            images = dev(np.stack([load_image_bicubic01(paths[i], hw, device)[0] for i in idx]))
            gts = [dev(labels[idx]), dev(cxcywh_to_xyxy(boxes_n[idx] * s))]
            if pose:
                kk = kpts_n[idx].copy()
                kk[..., :2] *= s
                gts.append(dev(kk))
            gts.append(dev(mask[idx]))
            state, loss = step(state, images, *gts)
            losses.append(loss)
        log(mesh, f"epoch {epoch}: loss {mean_loss(losses):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)")

    save_on_main(mesh, state.model, lambda m: save_yolov8(args.out, m))
    log(mesh, f"train_yolo: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
