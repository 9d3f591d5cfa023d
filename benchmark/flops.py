"""The yardstick's arithmetic: the chip's published peaks, the FLOPs of
every conv and linear layer of a configuration's models at the plan's
input sizes, and kernel K1's roofline bound per call.

The count is taken from the benchmark's own plain models on the meta
device (shapes only), so it depends on the configuration alone, never on
what implements it.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .reference import models
from .reference.preprocess import Letterbox

#: One NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core FLOP/s, HBM3 bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


class _ConvCount(TorchFunctionMode):
    """Counts 2 * multiply-adds of every conv1d / conv2d / linear call."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.conv1d, torch.conv2d, F.conv1d, F.conv2d):
            self.total += 2 * out.numel() * args[1][0].numel()
        elif func is F.linear:
            self.total += 2 * out.numel() * args[1].shape[-1]
        return out


def conv_flops(model: nn.Module, shape: tuple, *args) -> int:
    """2 * multiply-adds of every conv and linear layer in one forward of
    `model` on a zero input of `shape`, counted from the shapes on the meta
    device."""
    model = model.to("meta")
    args = tuple(a.to("meta") for a in args)
    with torch.no_grad(), _ConvCount() as counter:
        model(torch.zeros(shape, device="meta"), *args)
    return counter.total


def flops_per_frame(cfg: dict, src_hw) -> dict:
    """FLOPs a frame of each model the configuration serves: one detect
    forward on the letterbox, one pose forward on the squash, one TrackNet
    window (stride-1 windows: one a frame), one court forward, one
    InpaintNet window."""
    p, q, b, c = cfg["players"], cfg["pose"], cfg["ball"], cfg["court"]
    with torch.device("meta"):
        lb = Letterbox(src_hw, p["imgsz"], "meta")
        h = lb.resize.mh.shape[0] + lb.top + lb.bottom
        w = lb.resize.mw.shape[0] + lb.left + lb.right
        out = {"players": conv_flops(models.YOLOv8(p["variant"], p["num_classes"]), (1, h, w, 3))}
        s = q["train_image_size"]
        out["pose"] = conv_flops(models.YOLOv8(q["variant"], 1, q["num_keypoints"]),
                                 (1, s, s, 3))
        d = models.tracknet_in_dim(b["seq_len"], b["bg_mode"])
        out["tracknet"] = conv_flops(models.TrackNet(d, b["seq_len"]),
                                     (1, b["height"], b["width"], d))
        if c["mode"] == "yolo":
            s = c["train_image_size"]
            out["court"] = conv_flops(models.YOLOv8(c["variant"], 1, c["num_keypoints"]),
                                      (1, s, s, 3))
        if b.get("inpaintnet"):
            n = b["inpaint_seq_len"]
            out["inpaintnet"] = conv_flops(models.InpaintNet(), (1, n, 2), torch.zeros((1, n, 1)))
    return out


def k1_bound_s(b: int, h: int, w: int, cin: int, cout: int) -> float:
    """The least time of one stride-1 3x3 conv + affine + act on the card:
    the larger of 2 * M * N * K FLOPs over the bf16 rate and the bytes read
    once and written once (bf16 x, w and out; fp32 scale and bias) over the
    memory rate."""
    m = b * h * w
    flops = 2 * m * cout * 9 * cin
    nbytes = 2 * m * cin + 2 * 9 * cin * cout + 8 * cout + 2 * m * cout
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S)
