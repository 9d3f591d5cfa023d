"""TrackNet training: heatmap labels, the weighted BCE and the train step.

Counterpart of ``padel_analytics_tpu/training/tracknet.py``:

- binary-disc heatmap labels with the reference's geometry (radius sigma
  around (cx + 1, cy + 1) on a 1-based grid, an all-zero map for a (0, 0)
  ball);
- the focal-weighted BCE over heatmaps (TrackNetV3's WBCE);
- a train step over (x (B, H, W, C_in), labels (B, H, W, L)), alone or
  data-parallel over a `Mesh` (training/state.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.layers import batch_stats_over
from .state import TrainState, apply_gradients, global_sum


def gaussian_heatmap_labels(centers: torch.Tensor, height: int, width: int,
                            sigma: float = 2.5, mag: float = 1.0) -> torch.Tensor:
    """(..., 2) (cx, cy) heatmap pixels -> (..., height, width) fp32 discs:
    1 (times `mag`) within `sigma` of (cx + 1, cy + 1) on a 1-based grid,
    all zero where the ball is absent ((0, 0))."""
    centers = centers.float()
    cx, cy = centers[..., 0], centers[..., 1]
    xs = torch.arange(1, width + 1, dtype=torch.float32, device=centers.device)
    ys = torch.arange(1, height + 1, dtype=torch.float32, device=centers.device)
    d2 = (ys[:, None] - (cy[..., None, None] + 1.0)) ** 2 + (
        xs[None, :] - (cx[..., None, None] + 1.0)) ** 2
    disc = (d2 <= sigma ** 2).float() * mag
    present = ~((cx == 0) & (cy == 0))
    return disc * present[..., None, None].float()


def _wbce_terms(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    eps = 1e-7
    p = torch.clamp(pred, eps, 1 - eps)
    return (1 - p) ** 2 * target * torch.log(p) + p ** 2 * (1 - target) * torch.log(1 - p)


def weighted_bce_loss(pred: torch.Tensor, target: torch.Tensor, mesh=None) -> torch.Tensor:
    """Focal-weighted BCE: hard positives and negatives weighted
    quadratically; the mean over every element (of the global batch, this
    rank's share of it with a mesh)."""
    n = global_sum(torch.tensor(float(pred.numel()), device=pred.device), mesh)
    return -_wbce_terms(pred, target).sum() / n


def tracknet_loss(model, x: torch.Tensor, labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """The train-mode forward and the WBCE: this rank's share of the loss
    (the whole loss without a mesh)."""
    with batch_stats_over(model, mesh):
        pred = model(x)
    return weighted_bce_loss(pred, labels, mesh)


def make_tracknet_train_step(mesh=None) -> Callable:
    """(state, x (B, H, W, C_in) in [0, 1], labels (B, H, W, L)) -> (state,
    the global loss). With `mesh`, x and labels are this rank's shard."""

    def train_step(state: TrainState, x: torch.Tensor, labels: torch.Tensor):
        return apply_gradients(state, lambda: tracknet_loss(state.model, x, labels, mesh), mesh)

    return train_step
