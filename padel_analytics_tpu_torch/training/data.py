"""Training data: the reference's rally-directory layout into batches.

Counterpart of ``padel_analytics_tpu/training/data.py``. The reference
trains from

    <match_dir>/frame/<rally_id>/<frame>.png      (decoded frames)
    <match_dir>/csv/<rally_id>_ball.csv           (Frame,X,Y,Visibility)
    <match_dir>/frame/<rally_id>/median.npz       (optional median)
    <match_dir>/predicted_csv/<rally_id>_ball.csv (InpaintNet's coordinate
                                                   mode)

Frames are squashed with the PIL-parity bicubic resize (ops/resize.py) and
the median comes from ops/median.py; the window batches, their heatmap
labels and the frame mixup are made on the device the caller names. Images
are decoded with OpenCV (imported lazily), or with Pillow where OpenCV is
absent (PNG decodes to the same pixels).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from ..ops.median import median_background
from ..ops.resize import resize_plan
from .augmentation import frame_mixup
from .tracknet import gaussian_heatmap_labels


def imread_rgb(path) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB; FileNotFoundError if it does
    not decode."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(str(path))
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image

    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except (FileNotFoundError, OSError) as e:
        raise FileNotFoundError(path) from e


def _squash_u8(images: np.ndarray, hw: tuple[int, int], device) -> np.ndarray:
    """(..., H, W, 3) -> the PIL bicubic squash to hw, Pillow's uint8
    rounding, as uint8."""
    plan = resize_plan(tuple(images.shape[-3:-1]), tuple(hw), "pil_bicubic")
    out = plan.apply(torch.from_numpy(np.ascontiguousarray(images)).to(device))
    return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8).cpu().numpy()


def load_image_bicubic01(path, hw: tuple[int, int],
                         device="cpu") -> tuple[np.ndarray, tuple[int, int]]:
    """Decode an image, squash it to hw with the PIL-parity bicubic, round
    to uint8 as Pillow does, scale to [0, 1] float32: the one recipe the
    YOLO / court train apps and the evaluation share. Returns (image01,
    (src_w, src_h))."""
    img = imread_rgb(path)
    return _squash_u8(img, hw, device).astype(np.float32) / 255.0, (img.shape[1], img.shape[0])


def _read_csv(path: Path) -> list[dict]:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    rows.sort(key=lambda r: int(r["Frame"]))
    return rows


@dataclass
class RallyClip:
    frames: np.ndarray  # (N, H, W, 3) uint8 at model resolution
    coords: np.ndarray  # (N, 2) float32 truncated ball coords, model px
    visibility: np.ndarray  # (N,) float32
    median: np.ndarray  # (H, W, 3) uint8 at model resolution
    coords_src: Optional[np.ndarray] = None  # (N, 2) float32 source-resolution coords


def load_rally(match_dir, rally_id: str, height: int = 288, width: int = 512,
               img_format: str = "png", device="cpu") -> RallyClip:
    """One rally directory -> a RallyClip (the resize and the median run on
    `device`)."""
    match_dir = Path(match_dir)
    frame_dir = match_dir / "frame" / rally_id
    rows = _read_csv(match_dir / "csv" / f"{rally_id}_ball.csv")
    raw = np.stack([imread_rgb(frame_dir / f"{r['Frame']}.{img_format}") for r in rows])
    src_hw = raw.shape[1:3]
    median_path = frame_dir / "median.npz"
    if median_path.exists():
        median_full = np.load(median_path)["median"].astype(np.uint8)
    else:
        median_full = median_background(raw, device=device)

    resized = _squash_u8(raw, (height, width), device)
    med = _squash_u8(median_full.astype(np.float32), (height, width), device)

    scale = np.array([width / src_hw[1], height / src_hw[0]], np.float32)
    coords_src = np.asarray([(float(r["X"]), float(r["Y"])) for r in rows], np.float32)
    # The reference's label centres are int-truncated model coordinates
    # (dataset.py:547,587).
    coords = np.trunc(coords_src * scale).astype(np.float32)
    vis = np.asarray([float(r["Visibility"]) for r in rows], np.float32)
    coords[vis == 0] = 0.0  # absent balls are (0, 0), as the reference's
    coords_src[vis == 0] = 0.0
    return RallyClip(frames=resized, coords=coords, visibility=vis, median=med,
                     coords_src=coords_src)


@dataclass
class InpaintRally:
    """One rally's coordinate-trajectory training data (the reference's
    'coordinate' mode): TrackNet predictions, ground truth and an inpaint
    mask, in source pixels."""

    coords_pred: np.ndarray  # (N, 2) float32
    coords_gt: np.ndarray  # (N, 2) float32
    vis_pred: np.ndarray  # (N,) float32
    vis_gt: np.ndarray  # (N,) float32
    inpaint_mask: np.ndarray  # (N,) float32, 1 = region to inpaint
    img_wh: tuple[int, int]  # (w, h) source resolution


def load_inpaint_rally(match_dir, rally_id: str, img_wh: Optional[tuple[int, int]] = None,
                       img_format: str = "png") -> InpaintRally:
    """<match_dir>/predicted_csv/<rally_id>_ball.csv (Frame, X, Y,
    Visibility, X_GT, Y_GT, Visibility_GT, Inpaint_Mask) -> an InpaintRally;
    img_wh defaults to the first frame image's size."""
    match_dir = Path(match_dir)
    rows = _read_csv(match_dir / "predicted_csv" / f"{rally_id}_ball.csv")

    def col(name, default=None):
        return np.asarray([float(r[name]) if r.get(name, "") not in ("", None) else default
                           for r in rows], np.float32)

    if img_wh is None:
        probe = match_dir / "frame" / rally_id / f"{rows[0]['Frame']}.{img_format}"
        try:
            img = imread_rgb(probe)
        except FileNotFoundError:
            raise ValueError(f"pass img_wh: no frame image at {probe} to infer it from") from None
        img_wh = (img.shape[1], img.shape[0])
    return InpaintRally(
        coords_pred=np.stack([col("X"), col("Y")], axis=-1),
        coords_gt=np.stack([col("X_GT", 0.0), col("Y_GT", 0.0)], axis=-1),
        vis_pred=col("Visibility", 0.0),
        vis_gt=col("Visibility_GT", 0.0),
        inpaint_mask=col("Inpaint_Mask", 0.0),
        img_wh=img_wh,
    )


def synthesize_inpaint_rally(coords_gt: np.ndarray, vis_gt: np.ndarray,
                             img_wh: tuple[int, int], rng: np.random.Generator,
                             gap_rate: float = 0.08, max_gap: int = 12,
                             jitter_px: float = 1.5) -> InpaintRally:
    """InpaintNet training data from ground truth alone: random spans of
    visible frames are dropped (zeroed, as a missed detection) and flagged
    in the inpaint mask; kept detections get N(0, jitter_px) noise. The
    draws are the JAX package's, in its order, from `rng`."""
    n = len(vis_gt)
    coords_pred = coords_gt.astype(np.float32).copy()
    coords_pred += rng.normal(0.0, jitter_px, coords_pred.shape).astype(np.float32)
    vis_pred = vis_gt.astype(np.float32).copy()
    mask = np.zeros(n, np.float32)
    i = 0
    while i < n:
        if vis_gt[i] > 0 and rng.random() < gap_rate:
            j = min(n, i + int(rng.integers(1, max_gap + 1)))
            mask[i:j] = 1.0
            coords_pred[i:j] = 0.0
            vis_pred[i:j] = 0.0
            i = j
        else:
            i += 1
    coords_pred[vis_gt == 0] = 0.0
    return InpaintRally(coords_pred=coords_pred, coords_gt=coords_gt.astype(np.float32),
                        vis_pred=vis_pred, vis_gt=vis_gt.astype(np.float32),
                        inpaint_mask=mask, img_wh=img_wh)


def coordinate_window_batches(rally: InpaintRally, seq_len: int = 16, batch_size: int = 8,
                              rng: Optional[np.random.Generator] = None, sliding_step: int = 1,
                              device="cpu") -> Iterator[tuple[torch.Tensor, ...]]:
    """(coords (B, L, 2), mask (B, L, 1), target (B, L, 2)) batches of
    stride-`sliding_step` windows normalised by the source size, shuffled
    by `rng`; a remainder smaller than a batch is dropped."""
    n = rally.coords_pred.shape[0]
    num_windows = (n - seq_len) // sliding_step + 1
    if num_windows <= 0:
        return
    rng = rng or np.random.default_rng(0)
    scale = np.asarray(rally.img_wh, np.float32)
    starts = np.arange(num_windows) * sliding_step
    order = rng.permutation(num_windows)
    for lo in range(0, num_windows - batch_size + 1, batch_size):
        idx = starts[order[lo: lo + batch_size]][:, None] + np.arange(seq_len)[None, :]
        yield tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in (
            rally.coords_pred[idx] / scale, rally.inpaint_mask[idx][..., None],
            rally.coords_gt[idx] / scale))


def window_batches(clip: RallyClip, seq_len: int = 8, batch_size: int = 8,
                   rng: Optional[np.random.Generator] = None, mixup_alpha: float = 0.0,
                   mixup_rng: Optional[np.random.Generator] = None, sigma: float = 2.5,
                   device="cpu") -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """(x (B, H, W, (L + 1) * 3) in [0, 1], labels (B, H, W, L)) batches of
    stride-1 windows shuffled by `rng`, with the frame mixup (its draws from
    `mixup_rng`) where mixup_alpha > 0; made on `device`. The median leads
    the channel stack (the 'concat' background mode)."""
    n = clip.frames.shape[0]
    h, w = clip.frames.shape[1:3]
    num_windows = n - seq_len + 1
    if num_windows <= 0:
        return
    rng = rng or np.random.default_rng(0)
    mixup_rng = mixup_rng or np.random.default_rng(0)
    order = rng.permutation(num_windows)
    med = torch.from_numpy(clip.median).to(device).float()
    src = clip.coords_src if clip.coords_src is not None else clip.coords
    for lo in range(0, num_windows - batch_size + 1, batch_size):
        idx = order[lo: lo + batch_size][:, None] + np.arange(seq_len)[None, :]
        frames = torch.from_numpy(clip.frames[idx]).to(device).float()  # (B, L, H, W, 3)
        coords = torch.from_numpy(clip.coords[idx]).to(device)
        vis = torch.from_numpy(clip.visibility[idx]).to(device)
        if mixup_alpha > 0:
            coords_src = torch.from_numpy(src[idx]).to(device)
            outs = [frame_mixup(mixup_rng, frames[i], coords[i], vis[i], h, w, sigma=sigma,
                                alpha=mixup_alpha, coords_src=coords_src[i])
                    for i in range(batch_size)]
            frames = torch.stack([o[0] for o in outs])
            heat = torch.stack([o[1] for o in outs])
        else:
            heat = gaussian_heatmap_labels(coords, h, w, sigma) * vis[..., None, None]
        parts = [med.expand(batch_size, h, w, 3)] + [frames[:, j] for j in range(seq_len)]
        yield torch.cat(parts, dim=-1) / 255.0, heat.permute(0, 2, 3, 1)
