"""Image resampling as two matrix products (PIL-parity bicubic resize,
OpenCV-parity bilinear letterbox).

Counterpart of ``padel_analytics_tpu/ops/resize.py``. A resize from (H, W)
to (H', W') is ``out = R_h @ img @ R_w^T`` per channel, with R_h, R_w the
precomputed interpolation-weight matrices:

- `pil_resample_matrix`: Pillow's convolution resampling (antialias and
  edge renormalisation included, coefficients on Pillow's 2^-22 fixed-point
  grid). Pillow quantises the intermediate image to uint8 between the
  horizontal and the vertical pass; plans of the ``pil_*`` methods keep
  that step, which byte-level parity needs.
- `cv2_bilinear_matrix`: OpenCV INTER_LINEAR (half-pixel centres, two taps,
  edge clamp, no antialias), the resize inside ultralytics' letterbox; no
  intermediate quantisation.

`apply` runs each pass as fp32 matmuls with TF32 off (TF32 keeps ~10
mantissa bits and would move results by whole intensity steps), in one of
two forms, chosen per pass exactly as the JAX package chooses:

- dense: the whole (dst, src) matrix;
- block-banded (`_band_plan`): the dst axis in tiles of 128 rows, each
  multiplying only the source band that holds its rows' taps, gathered
  from the image and run as one batched matmul. The same per-row tap
  products; taken where the dense pass does more than 5x the banded MACs
  and the axis holds more than one tile (the pose squash's passes from
  1080p). At 1080p both letterbox passes (ratios 5.0 and 2.6) and the
  ball resize stay dense.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ._fp32 import no_tf32


def _pil_filter(name: str):
    """Pillow filter kernels (Resample.c)."""
    if name == "bilinear":
        support = 1.0

        def f(x):
            x = np.abs(x)
            return np.where(x < 1.0, 1.0 - x, 0.0)

    elif name == "bicubic":
        support = 2.0
        a = -0.5

        def f(x):
            x = np.abs(x)
            return np.where(
                x < 1.0,
                ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0),
            )

    elif name == "nearest":
        support = 0.5

        def f(x):
            return np.where((x >= -0.5) & (x < 0.5), 1.0, 0.0)

    elif name == "lanczos":
        support = 3.0

        def f(x):
            x = np.asarray(x, dtype=np.float64)
            out = np.sinc(x) * np.sinc(x / 3.0)
            return np.where(np.abs(x) < 3.0, out, 0.0)

    else:
        raise ValueError(f"unknown PIL filter {name!r}")
    return f, support


# Pillow's PRECISION_BITS (Resample.c): coefficients on a 2^-22 grid, which
# float32 holds exactly.
_PIL_PRECISION_BITS = 32 - 8 - 2


def pil_resample_matrix(src: int, dst: int, filter: str = "bicubic") -> np.ndarray:
    """(dst, src) weight matrix reproducing Pillow's 1-D resampling pass
    (precompute_coeffs in Pillow's Resample.c), antialias included."""
    f, support = _pil_filter(filter)
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = support * filterscale

    rows = np.zeros((dst, src), dtype=np.float64)
    one = 1 << _PIL_PRECISION_BITS
    for i in range(dst):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src)
        xs = np.arange(xmin, xmax)
        w = f((xs + 0.5 - center) / filterscale)
        ssum = w.sum()
        if ssum != 0:
            w = w / ssum
        # normalize_coeffs_8bpc: round-half-away-from-zero to fixed point.
        w = np.where(w < 0, np.ceil(w * one - 0.5), np.floor(w * one + 0.5)) / one
        rows[i, xmin:xmax] = w
    return rows


def cv2_bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) weight matrix reproducing cv2.resize INTER_LINEAR
    (half-pixel centres, 2-tap triangle, edge clamp, no antialias)."""
    rows = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(math.floor(x))
        frac = x - x0
        a = np.clip(x0, 0, src - 1)
        b = np.clip(x0 + 1, 0, src - 1)
        rows[i, a] += 1.0 - frac
        rows[i, b] += frac
    return rows.astype(np.float32)


#: The block-banded form's tile of dst rows, and its gate: banded only where
#: the dense pass does more than BAND_MIN_RATIO times the banded MACs (the
#: JAX package's defaults, `ResizePlan.apply`).
BAND_TILE = 128
BAND_MIN_RATIO = 5.0


def _band_plan(R: np.ndarray, tile: int):
    """Tile the dst axis of a (dst, src) resample matrix into blocks of
    `tile` rows and extract, per block, the contiguous src band that holds
    every nonzero tap of its rows. Returns (starts, W, n_tiles, B): `W[t]`
    is the (tile, B) dense sub-matrix such that
    ``out[t*tile:(t+1)*tile] = W[t] @ x[starts[t]:starts[t]+B]``; the band
    width B is uniform, a multiple of 8 and at most src, and each start is
    clamped so its band lies inside src (the JAX package's plan, unchanged)."""
    dst, src = R.shape
    nz = R != 0.0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, src - nz[:, ::-1].argmax(axis=1), 1)
    n_tiles = -(-dst // tile)
    starts, widths = [], []
    for t in range(n_tiles):
        r0, r1 = t * tile, min((t + 1) * tile, dst)
        s, e = int(lo[r0:r1].min()), int(hi[r0:r1].max())
        starts.append(s)
        widths.append(e - s)
    B = min(src, -(-max(widths) // 8) * 8)
    starts = [max(0, min(s, src - B)) for s in starts]
    W = np.zeros((n_tiles, tile, B), dtype=R.dtype)
    for t, s in enumerate(starts):
        r0, r1 = t * tile, min((t + 1) * tile, dst)
        W[t, : r1 - r0, :] = R[r0:r1, s: s + B]
    return np.asarray(starts), W, n_tiles, B


def takes_band(R: np.ndarray, band_plan, min_ratio: float = BAND_MIN_RATIO) -> bool:
    """Whether a pass over the (dst, src) matrix R with this `_band_plan`
    runs block-banded: its dense MACs exceed `min_ratio` times the banded
    ones and its dst axis holds more than one tile (the JAX package's gate,
    unchanged)."""
    dst, src = R.shape
    _, W, n_tiles, B = band_plan
    return dst * src > min_ratio * (B * n_tiles * W.shape[1]) and n_tiles > 1


@dataclass(frozen=True)
class ResizePlan:
    """Precomputed separable resize; `apply` runs as two matmul passes."""

    r_h: np.ndarray  # (dst_h, src_h)
    r_w: np.ndarray  # (dst_w, src_w)
    quantize_intermediate: bool = False
    # Each pass's band plans, and its operands on each device and form they
    # were used in: uploaded once, not per call (a pageable upload blocks
    # the host; ~15 MB for the dense 1080p -> 1280x1280 squash).
    _cache: dict = field(default_factory=dict, init=False, repr=False, compare=False,
                         hash=False)

    @property
    def dst_hw(self) -> tuple[int, int]:
        return (self.r_h.shape[0], self.r_w.shape[0])

    @property
    def src_hw(self) -> tuple[int, int]:
        return (self.r_h.shape[1], self.r_w.shape[1])

    def _passes(self):
        return (("w", self.r_w), ("h", self.r_h))

    def band_plan(self, axis: str, tile: int = BAND_TILE):
        """`_band_plan` of the horizontal ('w') or vertical ('h') pass."""
        key = ("band", axis, tile)
        if key not in self._cache:
            self._cache[key] = _band_plan(dict(self._passes())[axis], tile)
        return self._cache[key]

    def forms(self, banded: bool = True, tile: int = BAND_TILE,
              min_ratio: float = BAND_MIN_RATIO) -> tuple[str, ...]:
        """('dense' or 'banded') of the horizontal pass, then the vertical."""
        return tuple(
            "banded" if banded and takes_band(R, self.band_plan(axis, tile), min_ratio)
            else "dense" for axis, R in self._passes())

    def upload(self, device: torch.device, banded: bool = True, tile: int = BAND_TILE,
               min_ratio: float = BAND_MIN_RATIO) -> tuple[tuple, ...]:
        """The horizontal and the vertical pass's operands on `device`, each
        uploaded on its first use: ('dense', R) with R (dst, src) fp32, or
        ('banded', index, W, dst) with the bands' source indices (n_tiles *
        B,) int64 and W (n_tiles, tile, B) fp32."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        ops = []
        for (axis, R), form in zip(self._passes(), self.forms(banded, tile, min_ratio)):
            key = (device, axis, form, tile if form == "banded" else None)
            op = self._cache.get(key)
            if op is None:
                if form == "dense":
                    op = ("dense", torch.as_tensor(R, dtype=torch.float32, device=device))
                else:
                    starts, W, _, B = self.band_plan(axis, tile)
                    index = (starts[:, None] + np.arange(B)).reshape(-1)
                    op = ("banded", torch.as_tensor(index, dtype=torch.int64, device=device),
                          torch.as_tensor(W, dtype=torch.float32, device=device), R.shape[0])
                self._cache[key] = op
            ops.append(op)
        return tuple(ops)

    def apply(self, images: torch.Tensor, dtype: torch.dtype = torch.float32,
              banded: bool = True, tile: int = BAND_TILE,
              min_ratio: float = BAND_MIN_RATIO) -> torch.Tensor:
        """Resize a (..., H, W, C) stack to (..., H', W', C), computed in
        `dtype`: the horizontal pass, Pillow's uint8 clip of the intermediate
        where the plan quantises, then the vertical pass; each dense or
        banded as `forms` says."""
        x = images.to(dtype)
        op_w, op_h = self.upload(x.device, banded, tile, min_ratio)
        if dtype != torch.float32:  # the operands are kept in fp32
            op_w, op_h = (tuple(t.to(dtype) if torch.is_tensor(t) and t.is_floating_point()
                                else t for t in op) for op in (op_w, op_h))
        with no_tf32():
            x = _pass(x, op_w, -2)
            if self.quantize_intermediate:
                # Pillow's clip8: round half up, clamp to uint8.
                x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
            return _pass(x, op_h, -3)


def _pass(x: torch.Tensor, op: tuple, axis: int) -> torch.Tensor:
    """One resampling pass contracting `axis` (-2: W, -3: H) of a
    (..., H, W, C) stack with a pass's operands (`ResizePlan.upload`)."""
    if op[0] == "dense":
        if axis == -2:
            return torch.einsum("...hwc,pw->...hpc", x, op[1])
        return torch.einsum("...hwc,oh->...owc", x, op[1])
    _, index, wt, dst = op
    n, tile, band = wt.shape
    dim = x.dim() + axis
    lead, rest = x.shape[:dim], x.shape[dim + 1:]
    bands = x.index_select(dim, index).reshape(lead + (n, band) + rest)
    if axis == -2:
        out = torch.einsum("...nbc,ntb->...ntc", bands, wt)
    else:
        out = torch.einsum("...nbwc,ntb->...ntwc", bands, wt)
    return out.reshape(lead + (n * tile,) + rest).narrow(dim, 0, dst)


@functools.lru_cache(maxsize=64)
def resize_plan(
    src_hw: tuple[int, int],
    dst_hw: tuple[int, int],
    method: str = "pil_bicubic",
) -> ResizePlan:
    """Build (and cache) a ResizePlan.

    method: 'pil_bicubic' | 'pil_bilinear' | 'pil_nearest' | 'pil_lanczos'
            | 'cv2_linear'
    """
    (sh, sw), (dh, dw) = src_hw, dst_hw
    if method.startswith("pil_"):
        filt = method[len("pil_"):]
        return ResizePlan(
            r_h=pil_resample_matrix(sh, dh, filt),
            r_w=pil_resample_matrix(sw, dw, filt),
            quantize_intermediate=True,
        )
    if method == "cv2_linear":
        return ResizePlan(r_h=cv2_bilinear_matrix(sh, dh), r_w=cv2_bilinear_matrix(sw, dw))
    raise ValueError(f"unknown resize method {method!r}")


@dataclass(frozen=True)
class LetterboxPlan:
    """Ultralytics letterbox: aspect-preserving cv2-linear resize, then
    constant padding (value 114) to a stride-aligned canvas, as
    LetterBox(auto=True, stride=32) does inside YOLO.predict."""

    plan: ResizePlan
    pad_top: int
    pad_left: int
    out_h: int
    out_w: int
    gain: float  # scale from source to resized

    def apply(self, images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(..., H, W, 3) source frames -> (..., out_h, out_w, 3) in `dtype`."""
        resized = self.plan.apply(images, dtype)
        new_h, new_w = self.plan.dst_hw
        pad_bottom = self.out_h - new_h - self.pad_top
        pad_right = self.out_w - new_w - self.pad_left
        return F.pad(resized, (0, 0, self.pad_left, pad_right, self.pad_top, pad_bottom),
                     value=114.0)

    def boxes_to_source(self, boxes_xyxy: torch.Tensor) -> torch.Tensor:
        """Map (..., 4) xyxy boxes from letterboxed to source pixels."""
        pad = torch.tensor([self.pad_left, self.pad_top, self.pad_left, self.pad_top],
                           dtype=boxes_xyxy.dtype, device=boxes_xyxy.device)
        return (boxes_xyxy - pad) / self.gain

    def points_to_source(self, points_xy: torch.Tensor) -> torch.Tensor:
        pad = torch.tensor([self.pad_left, self.pad_top], dtype=points_xy.dtype,
                           device=points_xy.device)
        return (points_xy - pad) / self.gain


@functools.lru_cache(maxsize=16)
def letterbox_plan(src_hw: tuple[int, int], imgsz: int, stride: int = 32,
                   auto: bool = True) -> LetterboxPlan:
    """Plan an ultralytics letterbox of (h, w) frames to imgsz: 1080x1920
    goes to 360x640, padded to 384x640 with pad_top 12."""
    h, w = src_hw
    r = min(imgsz / h, imgsz / w)
    new_w, new_h = round(w * r), round(h * r)
    if auto:
        out_w = math.ceil(new_w / stride) * stride
        out_h = math.ceil(new_h / stride) * stride
    else:
        out_w = out_h = imgsz
    dw, dh = (out_w - new_w) / 2, (out_h - new_h) / 2
    pad_left, pad_top = int(round(dw - 0.1)), int(round(dh - 0.1))
    return LetterboxPlan(
        plan=resize_plan((h, w), (new_h, new_w), "cv2_linear"),
        pad_top=pad_top,
        pad_left=pad_left,
        out_h=out_h,
        out_w=out_w,
        gain=r,
    )
