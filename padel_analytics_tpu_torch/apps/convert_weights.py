"""Convert reference torch checkpoints to the JAX package's weights: a Flax
.msgpack file, or for an OUT with any other name an orbax checkpoint
directory.

Counterpart of ``padel_analytics_tpu/apps/convert_weights.py``, with its
command line:

  python -m padel_analytics_tpu_torch.apps.convert_weights tracknet   IN.pt OUT.msgpack
  python -m padel_analytics_tpu_torch.apps.convert_weights inpaintnet IN.pt OUT.msgpack
  python -m padel_analytics_tpu_torch.apps.convert_weights resnet     IN.pt OUT.msgpack
  python -m padel_analytics_tpu_torch.apps.convert_weights yolo       IN.pt OUT.msgpack \\
      [--variant m] [--keypoints 0|13|12] [--imgsz 640] [--classes N]

The .pt is read with the port's converters (models/convert.py, the loaders
its trackers use) into the port's model of that kind, which checks every
name and shape; the model's weights are written as the ``{'params',
'batch_stats'}`` tree the JAX package's `_engine.load_variables` builds for
the same model (`flax_from_state_dict`, core/checkpoint.py). The port's
trackers and the JAX package's both load it. YOLOv8's class count is
read from the checkpoint's cls head (80 for stock COCO weights); a
`--classes` that disagrees exits. `--imgsz` is the JAX CLI's (it sizes the
Flax init there): the weights do not depend on it.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="convert_weights")
    parser.add_argument("kind", choices=["tracknet", "inpaintnet", "resnet", "yolo"])
    parser.add_argument("input")
    parser.add_argument("output", help="a .msgpack file, or any other path for an orbax "
                        "checkpoint directory (must not exist)")
    parser.add_argument("--variant", default="m")
    parser.add_argument("--keypoints", type=int, default=0)
    parser.add_argument("--imgsz", type=int, default=640)
    parser.add_argument(
        "--classes", type=int, default=0,
        help="yolo: assert this class count (0 = infer from checkpoint)",
    )
    args = parser.parse_args(argv)

    from ..models.convert import (
        convert_inpaintnet_checkpoint,
        convert_tracknet_checkpoint,
        load_torch_checkpoint,
        save_flax,
    )

    if args.kind == "tracknet":
        from ..models.tracknet import make_tracknet

        state_dict, params = convert_tracknet_checkpoint(load_torch_checkpoint(args.input))
        seq_len = int(params.get("seq_len", 8))
        model, _ = make_tracknet(seq_len, params.get("bg_mode", "concat"))
        print(f"tracknet: seq_len={seq_len} bg_mode={params.get('bg_mode')}")
    elif args.kind == "inpaintnet":
        from ..models.tracknet import InpaintNet

        state_dict, _ = convert_inpaintnet_checkpoint(load_torch_checkpoint(args.input))
        model = InpaintNet()
    elif args.kind == "resnet":
        from ..models.resnet import ResNet50Regressor
        from ..trackers.court_keypoints import _load_resnet

        state_dict = _load_resnet(args.input)
        model = ResNet50Regressor()
    else:  # yolo
        from ..models.yolov8 import YOLOv8
        from ..trackers.players import _load_yolo

        state_dict = _load_yolo(args.input)
        # The class count from the checkpoint's cls head, as PlayerTracker
        # reads it: the stock COCO players checkpoint has 80.
        ckpt_nc = int(state_dict["cls_0.proj.weight"].shape[0])
        if args.classes and args.classes != ckpt_nc:
            raise SystemExit(f"--classes {args.classes} but checkpoint has {ckpt_nc}")
        model = YOLOv8(args.variant, num_classes=ckpt_nc, num_keypoints=args.keypoints)

    model.load_state_dict(state_dict)
    save_flax(args.output, model)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
