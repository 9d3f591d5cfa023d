"""Plain float32 PyTorch models the benchmark judges the port against.

Frozen, self-contained copies of the architectures the port serves:
YOLOv8 (detect and pose heads, ultralytics' yolov8m.yaml scaled by depth
0.67, width 0.75, max_channels 768), TrackNetV3's TrackNet and InpaintNet.
No kernel, no cache, no batching trick: every conv is `F.conv2d` /
`F.conv1d` in NCHW, BatchNorm in eval mode, the decode in float32. The
parameter names equal the port's, so one state dict loads into both.

`Quant` is the control's knob: when a model's `quant` is set, every conv's
input, weight and output pass through it (the lower precision the control
computes in); None leaves the float32 path untouched.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

VARIANTS = {"m": (0.67, 0.75, 768)}
BASE_CHANNELS = (64, 128, 256, 512, 1024)
BASE_DEPTHS = (3, 6, 6, 3)
REG_MAX = 16
STRIDES = (8, 16, 32)


def _conv(x: torch.Tensor, conv: nn.Module, quant: Quant) -> torch.Tensor:
    """The conv of `conv`'s parameters; under `quant` its input, weight and
    output each pass through `quant` (the tensors a lower precision holds)."""
    w = conv.weight
    if quant is not None:
        x, w = quant(x), quant(w)
    fn = F.conv2d if w.dim() == 4 else F.conv1d
    y = fn(x, w, conv.bias, stride=conv.stride, padding=conv.padding)
    return y if quant is None else quant(y)


class ConvBN(nn.Module):
    """Conv (no bias) + eval BatchNorm + activation, NCHW."""

    def __init__(self, cin: int, cout: int, k: int = 3, s: int = 1, act: str = "relu",
                 eps: float = 1e-5):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, padding=k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps)
        self.act = act
        self.quant: Quant = None

    def forward(self, x):
        y = self.bn(_conv(x, self.conv, self.quant))
        return F.silu(y) if self.act == "silu" else F.relu(y)


def _yconv(cin, cout, k=1, s=1):
    return ConvBN(cin, cout, k, s, act="silu", eps=1e-3)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool):
        super().__init__()
        self.cv1 = _yconv(cin, cout, 3)
        self.cv2 = _yconv(cout, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, shortcut: bool):
        super().__init__()
        self.c = cout // 2
        self.n = n
        self.cv1 = _yconv(cin, 2 * self.c)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(self.c, self.c, shortcut))
        self.cv2 = _yconv((2 + n) * self.c, cout)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m_{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        c = cin // 2
        self.cv1 = _yconv(cin, c)
        self.cv2 = _yconv(4 * c, cout)

    def forward(self, x):
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([x, p1, p2, p3], dim=1))


class _Branch(nn.Module):
    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.c0 = _yconv(cin, mid, 3)
        self.c1 = _yconv(mid, mid, 3)
        self.proj = nn.Conv2d(mid, out, 1)
        self.quant: Quant = None

    def forward(self, x):
        return _conv(self.c1(self.c0(x)), self.proj, self.quant)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv8(nn.Module):
    """YOLOv8 detect (+ pose) -> boxes (B, A, 4) xyxy input px, scores (B, A,
    nc) sigmoid, kpts (B, A, K, 3) with conf sigmoid; images (B, H, W, 3) in
    [0, 1]."""

    def __init__(self, variant: str = "m", num_classes: int = 1, num_keypoints: int = 0):
        super().__init__()
        depth, width, max_ch = VARIANTS[variant]
        ch = [int(math.ceil(min(c, max_ch) * width / 8) * 8) for c in BASE_CHANNELS]
        n = [max(round(d * depth), 1) for d in BASE_DEPTHS]
        self.num_classes, self.num_keypoints = num_classes, num_keypoints
        self.stem = _yconv(3, ch[0], 3, 2)
        self.down1 = _yconv(ch[0], ch[1], 3, 2)
        self.c2f_1 = C2f(ch[1], ch[1], n[0], True)
        self.down2 = _yconv(ch[1], ch[2], 3, 2)
        self.c2f_2 = C2f(ch[2], ch[2], n[1], True)
        self.down3 = _yconv(ch[2], ch[3], 3, 2)
        self.c2f_3 = C2f(ch[3], ch[3], n[2], True)
        self.down4 = _yconv(ch[3], ch[4], 3, 2)
        self.c2f_4 = C2f(ch[4], ch[4], n[3], True)
        self.sppf = SPPF(ch[4], ch[4])
        self.neck_c2f_1 = C2f(ch[4] + ch[3], ch[3], n[0], False)
        self.neck_c2f_2 = C2f(ch[3] + ch[2], ch[2], n[0], False)
        self.neck_down1 = _yconv(ch[2], ch[2], 3, 2)
        self.neck_c2f_3 = C2f(ch[2] + ch[3], ch[3], n[0], False)
        self.neck_down2 = _yconv(ch[3], ch[3], 3, 2)
        self.neck_c2f_4 = C2f(ch[3] + ch[4], ch[4], n[0], False)
        c2 = max(16, ch[2] // 4, REG_MAX * 4)
        c3 = max(ch[2], min(num_classes, 100))
        nk = num_keypoints * 3
        c4 = max(ch[2] // 4, nk) if nk else 0
        for i, f in enumerate((ch[2], ch[3], ch[4])):
            self.add_module(f"box_{i}", _Branch(f, c2, 4 * REG_MAX))
            self.add_module(f"cls_{i}", _Branch(f, c3, num_classes))
            if nk:
                self.add_module(f"kpt_{i}", _Branch(f, c4, nk))

    def forward(self, images: torch.Tensor, raw: bool = False) -> dict:
        x = images.permute(0, 3, 1, 2)
        x = self.c2f_1(self.down1(self.stem(x)))
        p3 = self.c2f_2(self.down2(x))
        p4 = self.c2f_3(self.down3(p3))
        p5 = self.sppf(self.c2f_4(self.down4(p4)))
        t1 = self.neck_c2f_1(torch.cat([_up2(p5), p4], dim=1))
        n3 = self.neck_c2f_2(torch.cat([_up2(t1), p3], dim=1))
        n4 = self.neck_c2f_3(torch.cat([self.neck_down1(n3), t1], dim=1))
        n5 = self.neck_c2f_4(torch.cat([self.neck_down2(n4), p5], dim=1))
        out = {"boxes": [], "scores": [], "kpts": [], "cls_logits": [], "kpt_raw": []}
        for i, (f, s) in enumerate(zip((n3, n4, n5), STRIDES)):
            b, _, h, w = f.shape

            def flat(t, last):
                return t.permute(0, 2, 3, 1).reshape(b, h * w, *last)

            box = flat(getattr(self, f"box_{i}")(f), (4, REG_MAX))
            cls = flat(getattr(self, f"cls_{i}")(f), (self.num_classes,))
            ax = (torch.arange(w, dtype=torch.float32, device=f.device) + 0.5).repeat(h)
            ay = (torch.arange(h, dtype=torch.float32, device=f.device) + 0.5).repeat_interleave(w)
            bins = torch.arange(REG_MAX, dtype=torch.float32, device=f.device)
            d = (torch.softmax(box, dim=-1) * bins).sum(-1)
            out["boxes"].append(torch.stack([(ax - d[..., 0]) * s, (ay - d[..., 1]) * s,
                                             (ax + d[..., 2]) * s, (ay + d[..., 3]) * s], -1))
            out["scores"].append(torch.sigmoid(cls))
            if raw:
                out["cls_logits"].append(cls)
            if self.num_keypoints:
                k = flat(getattr(self, f"kpt_{i}")(f), (self.num_keypoints, 3))
                if raw:
                    out["kpt_raw"].append(k)
                out["kpts"].append(torch.stack([
                    (k[..., 0] * 2.0 + (ax[None, :, None] - 0.5)) * s,
                    (k[..., 1] * 2.0 + (ay[None, :, None] - 0.5)) * s,
                    torch.sigmoid(k[..., 2])], -1))
        return {k: torch.cat(v, dim=1) for k, v in out.items() if v}


class _Stack(nn.Module):
    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"conv_{i + 1}", ConvBN(cin if i == 0 else cout, cout))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"conv_{i + 1}")(x)
        return x


class TrackNet(nn.Module):
    """TrackNetV3's heatmap U-Net: (N, H, W, in_dim) in [0, 1] -> (N, H, W,
    out_dim) sigmoid."""

    def __init__(self, in_dim: int, out_dim: int = 8):
        super().__init__()
        self.down_block_1 = _Stack(in_dim, 64, 2)
        self.down_block_2 = _Stack(64, 128, 2)
        self.down_block_3 = _Stack(128, 256, 3)
        self.bottleneck = _Stack(256, 512, 3)
        self.up_block_1 = _Stack(512 + 256, 256, 3)
        self.up_block_2 = _Stack(256 + 128, 128, 2)
        self.up_block_3 = _Stack(128 + 64, 64, 2)
        self.predictor = nn.Conv2d(64, out_dim, 1)
        self.quant: Quant = None

    def forward(self, x, logits: bool = False):
        x1 = self.down_block_1(x.permute(0, 3, 1, 2))
        x2 = self.down_block_2(F.max_pool2d(x1, 2))
        x3 = self.down_block_3(F.max_pool2d(x2, 2))
        x = self.bottleneck(F.max_pool2d(x3, 2))
        x = self.up_block_1(torch.cat([_up2(x), x3], dim=1))
        x = self.up_block_2(torch.cat([_up2(x), x2], dim=1))
        x = self.up_block_3(torch.cat([_up2(x), x1], dim=1))
        y = _conv(x, self.predictor, self.quant).permute(0, 2, 3, 1)
        return y if logits else torch.sigmoid(y)


class _C1(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 3, padding=1)
        self.quant: Quant = None

    def forward(self, x):
        return F.leaky_relu(_conv(x, self.conv, self.quant), 0.01)


class InpaintNet(nn.Module):
    """TrackNetV3's InpaintNet: coords (N, L, 2), mask (N, L, 1) -> (N, L, 2)."""

    def __init__(self):
        super().__init__()
        self.down_1, self.down_2, self.down_3 = _C1(3, 32), _C1(32, 64), _C1(64, 128)
        self.bottleneck_1, self.bottleneck_2 = _C1(128, 256), _C1(256, 256)
        self.up_1, self.up_2, self.up_3 = _C1(384, 128), _C1(192, 64), _C1(96, 32)
        self.predictor = nn.Conv1d(32, 2, 3, padding=1)
        self.quant: Quant = None

    def forward(self, coords, mask):
        x = torch.cat([coords, mask], dim=-1).permute(0, 2, 1)
        x1 = self.down_1(x)
        x2 = self.down_2(x1)
        x3 = self.down_3(x2)
        x = self.bottleneck_2(self.bottleneck_1(x3))
        x = self.up_1(torch.cat([x, x3], dim=1))
        x = self.up_2(torch.cat([x, x2], dim=1))
        x = self.up_3(torch.cat([x, x1], dim=1))
        return torch.sigmoid(_conv(x, self.predictor, self.quant)).permute(0, 2, 1)


def set_quant(model: nn.Module, quant: Quant) -> nn.Module:
    """Route every conv of `model` through `quant` (None: plain float32)."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = quant
    return model


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one per-tensor scale (amax to 448), back to
    float32: the precision one step below the configuration's bfloat16."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def tracknet_in_dim(seq_len: int, bg_mode: str) -> int:
    return seq_len * 3 + (3 if bg_mode == "concat" else 0)
