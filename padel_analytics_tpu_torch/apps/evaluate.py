"""Detection / pose evaluation CLI: mAP@[.5:.95] and mean OKS on an
ultralytics-layout dataset (the one apps/train_yolo.py trains on).

Counterpart of ``padel_analytics_tpu/apps/evaluate.py``. YOLOv8 runs in
eval mode: on the card in bf16, every stride-1 3x3 ConvBN through kernel
K1 (the trackers' numerics), on the CPU in fp32; then the port's NMS with
the trackers' person gating, then training/evaluate.py's metrics.

  python -m padel_analytics_tpu_torch.apps.evaluate \\
      --images data/images --labels data/labels \\
      --weights weights/det.pt --variant n --imgsz 640 \\
      [--keypoints 13] [--classes 1] [--conf 0.25 --iou 0.7] [--batch 8] [--device cpu]

Prints one JSON line: {"images": N, "map": ..., "map50": ...}, plus
"mean_oks" with --keypoints.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="evaluate")
    parser.add_argument("--images", required=True)
    parser.add_argument("--labels", required=True)
    parser.add_argument("--weights", required=True,
                        help="a YOLOv8 .pt / .pth, a .msgpack or an orbax checkpoint directory")
    parser.add_argument("--variant", default="n")
    parser.add_argument("--imgsz", type=int, default=640)
    parser.add_argument("--classes", type=int, default=1)
    parser.add_argument("--keypoints", type=int, default=0)
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--iou", type=float, default=0.7)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--max-gt", type=int, default=16)
    parser.add_argument("--top-k", type=int, default=128)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    import torch

    from ..models.yolov8 import YOLOv8
    from ..ops.nms import batched_nms
    from ..trackers._engine import Engine
    from ..trackers.players import _load_yolo, _person_scores
    from ..training.data import load_image_bicubic01
    from ..training.evaluate import detection_map, greedy_match, oks
    from ._train import resolve_device
    from .train_yolo import cxcywh_to_xyxy, load_dataset

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    pose = args.keypoints > 0
    hw = (args.imgsz, args.imgsz)
    model = Engine(YOLOv8(args.variant, args.classes, args.keypoints), device,
                   _load_yolo(args.weights)).model

    paths, labels, boxes_n, kpts_n, mask = load_dataset(args.images, args.labels, args.max_gt)
    if pose and (kpts_n is None or kpts_n.shape[2] != args.keypoints):
        raise ValueError(f"--keypoints {args.keypoints} but labels carry "
                         f"{0 if kpts_n is None else kpts_n.shape[2]} keypoints")
    print(f"evaluate: {len(paths)} images, pose={pose}, device {device}", file=sys.stderr)

    @torch.no_grad()
    def step(images):
        out = model(images.to(dtype))
        # The deployed trackers' gating (classes=[0] argmax semantics): the
        # eval scores what inference detects.
        boxes, scores, _, index, valid = batched_nms(
            out["boxes"], _person_scores(out["scores"]), conf_thres=args.conf,
            iou_thres=args.iou, top_k=args.top_k)
        res = [boxes.numpy(), scores.numpy(), valid.numpy()]
        if pose:
            # the kept anchors' keypoints, gathered by the NMS indices
            kpts = out["kpts"].cpu()
            idx = torch.clamp(index, min=0)[..., None, None].expand(-1, -1, *kpts.shape[2:])
            res.append(torch.gather(kpts, 1, idx).numpy())
        return res

    s = float(args.imgsz)
    pred_boxes, pred_scores, gt_all, oks_vals = [], [], [], []
    b = min(args.batch, len(paths))
    for lo in range(0, len(paths), b):
        idx = list(range(lo, min(lo + b, len(paths))))
        batch = [load_image_bicubic01(paths[i], hw, device)[0] for i in idx]
        while len(batch) < b:  # pad the tail; padded outputs are dropped
            batch.append(np.zeros_like(batch[0]))
        outs = step(torch.from_numpy(np.stack(batch)).to(device))
        for j, i in enumerate(idx):
            keep = outs[2][j]
            pb, ps = outs[0][j][keep], outs[1][j][keep]
            gb = cxcywh_to_xyxy(boxes_n[i][mask[i]] * s).reshape(-1, 4)
            pred_boxes.append(pb)
            pred_scores.append(ps)
            gt_all.append(gb)
            if pose and len(gb) and keep.any():
                gk = kpts_n[i][mask[i]].copy()
                gk[..., :2] *= s
                pk_all = outs[3][j][keep]  # row-aligned with pb / ps
                # the same greedy matching rule as detection_map
                order, gt_idx = greedy_match(pb, ps, gb, 0.5)
                for k, r in enumerate(order):
                    g = gt_idx[k]
                    if g < 0:
                        continue
                    area = float(max((gb[g, 2] - gb[g, 0]) * (gb[g, 3] - gb[g, 1]), 1e-9))
                    v = oks(pk_all[r][:, :2], gk[g], area)
                    if np.isfinite(v):
                        oks_vals.append(v)

    res = detection_map(pred_boxes, pred_scores, gt_all)
    record = {"images": len(paths), "map": round(res["map"], 4), "map50": round(res["map50"], 4)}
    if pose:
        record["mean_oks"] = round(float(np.mean(oks_vals)), 4) if oks_vals else None
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
