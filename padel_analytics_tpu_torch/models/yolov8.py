"""YOLOv8 detection and pose models, channels-last.

Counterpart of ``padel_analytics_tpu/models/yolov8.py``: the CSP backbone
with C2f blocks, SPPF, the PAN neck and the decoupled DFL detect head, with
an optional pose head, plus the decode ultralytics applies after the
forward pass (distribution-focal box expectation, stride-anchored offsets,
pose keypoints at (2 * raw + anchor - 0.5) * stride). Images (B, H, W, 3)
in [0, 1] go in, decoded (boxes, scores, keypoints) come out.

Every stride-1 3x3 ConvBN (the bottlenecks and the head branches) runs
through kernel K1 on CUDA (models/layers.py::ConvBN). Submodule names equal
the Flax tree's (``stem``, ``c2f_1.m_0.cv1.conv``, ``box_0.c0``,
``box_0.proj``, ...), so one bridge (models/convert.py::state_dict_from_flax)
serves this model and TrackNet. The model computes in its input's dtype;
the decode runs in fp32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import sharded_call
from .layers import ConvBN, upsample_nearest_2x

# name -> (depth_mult, width_mult, max_channels)
YOLOV8_VARIANTS = {
    "n": (0.34, 0.25, 1024),
    "s": (0.34, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

_BASE_CHANNELS = (64, 128, 256, 512, 1024)
_BASE_DEPTHS = (3, 6, 6, 3)
REG_MAX = 16
STRIDES = (8, 16, 32)


def _scale_ch(c: int, width: float, max_ch: int) -> int:
    return int(math.ceil(min(c, max_ch) * width / 8) * 8)


def _scale_d(n: int, depth: float) -> int:
    return max(round(n * depth), 1)


class YoloConv(ConvBN):
    """ultralytics Conv: conv + BN (eps 1e-3, Flax momentum 0.97) + SiLU."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1, stride: int = 1):
        super().__init__(in_features, features, kernel_size, stride, act="silu", bn_eps=1e-3,
                         bn_momentum=0.97)


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = YoloConv(in_features, features, 3)
        self.cv2 = YoloConv(features, features, 3)
        self.add = shortcut and in_features == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (``m_0`` .. ``m_{n-1}``)."""

    def __init__(self, in_features: int, features: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.c = features // 2
        self.n = n
        self.cv1 = YoloConv(in_features, 2 * self.c, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(self.c, self.c, shortcut))
        self.cv2 = YoloConv((2 + n) * self.c, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        # Non-contiguous channel slices: K1's wrapper copies them.
        parts = [y[..., : self.c], y[..., self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m_{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=-1))


def _max_pool_5x5(x: torch.Tensor) -> torch.Tensor:
    """5x5 / stride-1 max pool over NHWC, padded with -inf (Flax's SAME)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 5, 1, 2).permute(0, 2, 3, 1)


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5x5 max pools."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        c = in_features // 2
        self.cv1 = YoloConv(in_features, c, 1)
        self.cv2 = YoloConv(4 * c, features, 1)

    def forward(self, x):
        x = self.cv1(x)
        p1 = _max_pool_5x5(x)
        p2 = _max_pool_5x5(p1)
        p3 = _max_pool_5x5(p2)
        return self.cv2(torch.cat([x, p1, p2, p3], dim=-1))


def dfl_decode(box_logits: torch.Tensor, ax: torch.Tensor, ay: torch.Tensor,
               stride: float) -> torch.Tensor:
    """Distribution-focal box decode: per-side softmax expectation over
    REG_MAX bins -> (l, t, r, b) cell distances -> stride-scaled xyxy.
    box_logits (B, A, 4, REG_MAX); ax, ay (A,) anchor centres in cells."""
    bins = torch.arange(box_logits.shape[-1], dtype=torch.float32, device=box_logits.device)
    dist = torch.sum(torch.softmax(box_logits.float(), dim=-1) * bins, dim=-1)
    x1 = (ax[None] - dist[..., 0]) * stride
    y1 = (ay[None] - dist[..., 1]) * stride
    x2 = (ax[None] + dist[..., 2]) * stride
    y2 = (ay[None] + dist[..., 3]) * stride
    return torch.stack([x1, y1, x2, y2], dim=-1)


def pose_decode(kpt_raw: torch.Tensor, ax: torch.Tensor, ay: torch.Tensor,
                stride: float) -> torch.Tensor:
    """Pose keypoint decode (ultralytics kpts_decode): xy = (2 * raw +
    anchor - 0.5) * stride, conf = sigmoid. kpt_raw (B, A, K, 3)."""
    kpt_raw = kpt_raw.float()
    kx = (kpt_raw[..., 0] * 2.0 + (ax[None, :, None] - 0.5)) * stride
    ky = (kpt_raw[..., 1] * 2.0 + (ay[None, :, None] - 0.5)) * stride
    kc = torch.sigmoid(kpt_raw[..., 2])
    return torch.stack([kx, ky, kc], dim=-1)


class _HeadBranch(nn.Module):
    """Two 3x3 ConvBNs and a 1x1 projection with a bias (one head branch)."""

    def __init__(self, in_features: int, mid: int, out: int):
        super().__init__()
        self.c0 = YoloConv(in_features, mid, 3)
        self.c1 = YoloConv(mid, mid, 3)
        self.proj = nn.Conv2d(mid, out, 1)

    def forward(self, x):
        x = self.c1(self.c0(x))
        # Sharded over the mesh's 'model' axis where its weight is: the bias
        # added after the gather (parallel/tensor_parallel.py).
        y = sharded_call(self.proj, x.permute(0, 3, 1, 2), F.conv2d, dim=1)
        return y.permute(0, 2, 3, 1)


class YOLOv8(nn.Module):
    """YOLOv8 detect (+ optional pose) model.

    forward(images) -> dict with
      boxes  (B, A, 4) xyxy in input pixels, fp32
      scores (B, A, nc) sigmoid class scores, fp32
      kpts   (B, A, K, 3) decoded keypoints (if num_keypoints)
    and with raw=True also the head's box_logits (B, A, 4, REG_MAX),
    cls_logits (B, A, nc) and kpt_raw (B, A, K, 3). A = sum over strides s
    in (8, 16, 32) of H/s * W/s. images: (B, H, W, 3) in [0, 1], H and W
    multiples of 32.
    """

    def __init__(self, variant: str = "m", num_classes: int = 1, num_keypoints: int = 0):
        super().__init__()
        depth, width, max_ch = YOLOV8_VARIANTS[variant]
        chs = [_scale_ch(c, width, max_ch) for c in _BASE_CHANNELS]
        ns = [_scale_d(n, depth) for n in _BASE_DEPTHS]
        self.variant = variant
        self.num_classes = num_classes
        self.num_keypoints = num_keypoints

        # ---- backbone ----
        self.stem = YoloConv(3, chs[0], 3, 2)  # P1
        self.down1 = YoloConv(chs[0], chs[1], 3, 2)
        self.c2f_1 = C2f(chs[1], chs[1], ns[0], True)  # P2
        self.down2 = YoloConv(chs[1], chs[2], 3, 2)
        self.c2f_2 = C2f(chs[2], chs[2], ns[1], True)  # P3 /8
        self.down3 = YoloConv(chs[2], chs[3], 3, 2)
        self.c2f_3 = C2f(chs[3], chs[3], ns[2], True)  # P4 /16
        self.down4 = YoloConv(chs[3], chs[4], 3, 2)
        self.c2f_4 = C2f(chs[4], chs[4], ns[3], True)
        self.sppf = SPPF(chs[4], chs[4])  # P5 /32

        # ---- PAN neck ----
        self.neck_c2f_1 = C2f(chs[4] + chs[3], chs[3], ns[0], False)
        self.neck_c2f_2 = C2f(chs[3] + chs[2], chs[2], ns[0], False)  # /8
        self.neck_down1 = YoloConv(chs[2], chs[2], 3, 2)
        self.neck_c2f_3 = C2f(chs[2] + chs[3], chs[3], ns[0], False)  # /16
        self.neck_down2 = YoloConv(chs[3], chs[3], 3, 2)
        self.neck_c2f_4 = C2f(chs[3] + chs[4], chs[4], ns[0], False)  # /32

        # ---- heads ----
        c2 = max(16, chs[2] // 4, REG_MAX * 4)
        c3 = max(chs[2], min(num_classes, 100))
        nk = num_keypoints * 3
        c4 = max(chs[2] // 4, nk) if nk else 0
        for i, f in enumerate((chs[2], chs[3], chs[4])):
            self.add_module(f"box_{i}", _HeadBranch(f, c2, 4 * REG_MAX))
            self.add_module(f"cls_{i}", _HeadBranch(f, c3, num_classes))
            if nk:
                self.add_module(f"kpt_{i}", _HeadBranch(f, c4, nk))

    def forward(self, images: torch.Tensor, raw: bool = False) -> dict[str, torch.Tensor]:
        x = self.c2f_1(self.down1(self.stem(images)))
        p3 = self.c2f_2(self.down2(x))
        p4 = self.c2f_3(self.down3(p3))
        p5 = self.sppf(self.c2f_4(self.down4(p4)))

        t1 = self.neck_c2f_1(torch.cat([upsample_nearest_2x(p5), p4], dim=-1))
        n3 = self.neck_c2f_2(torch.cat([upsample_nearest_2x(t1), p3], dim=-1))
        n4 = self.neck_c2f_3(torch.cat([self.neck_down1(n3), t1], dim=-1))
        n5 = self.neck_c2f_4(torch.cat([self.neck_down2(n4), p5], dim=-1))

        nk = self.num_keypoints
        outs: dict[str, list[torch.Tensor]] = {k: [] for k in (
            "boxes", "scores", "kpts", "box_logits", "cls_logits", "kpt_raw")}
        for i, (f, stride) in enumerate(zip((n3, n4, n5), STRIDES)):
            b, h, w, _ = f.shape
            box = getattr(self, f"box_{i}")(f).reshape(b, h * w, 4, REG_MAX)
            cls = getattr(self, f"cls_{i}")(f).reshape(b, h * w, self.num_classes)
            # Anchor centres in feature cells (+0.5), scaled by the stride later.
            ax = (torch.arange(w, dtype=torch.float32, device=f.device) + 0.5).repeat(h)
            ay = (torch.arange(h, dtype=torch.float32, device=f.device) + 0.5).repeat_interleave(w)
            outs["boxes"].append(dfl_decode(box, ax, ay, stride))
            outs["scores"].append(torch.sigmoid(cls.float()))
            if raw:
                outs["box_logits"].append(box.float())
                outs["cls_logits"].append(cls.float())
            if nk:
                kpt = getattr(self, f"kpt_{i}")(f).reshape(b, h * w, nk, 3)
                outs["kpts"].append(pose_decode(kpt, ax, ay, stride))
                if raw:
                    outs["kpt_raw"].append(kpt.float())
        return {k: torch.cat(v, dim=1) for k, v in outs.items() if v}


def num_anchors(h: int, w: int) -> int:
    """Total anchors for an (h, w) input across strides 8/16/32."""
    return sum((h // s) * (w // s) for s in STRIDES)


def anchor_table(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-anchor (centres (A, 2) in cells (+0.5), strides (A,)) in the
    head's anchor order."""
    centers, strides = [], []
    for s in STRIDES:
        gh, gw = h // s, w // s
        yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        centers.append(np.stack([xx.reshape(-1) + 0.5, yy.reshape(-1) + 0.5], axis=-1))
        strides.append(np.full(gh * gw, s, np.float32))
    return (
        np.concatenate(centers).astype(np.float32),
        np.concatenate(strides).astype(np.float32),
    )
