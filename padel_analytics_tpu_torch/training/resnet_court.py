"""ResNet court-keypoint regression training: targets, loss and the step.

Counterpart of ``padel_analytics_tpu/training/resnet_court.py``: targets
are keypoints normalised to [0, 1] by the frame size (the quantity the
inference path scales by W and H), flattened x, y interleaved; the loss is
the (masked) MSE over sigmoid(fc).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.layers import batch_stats_over
from .state import TrainState, apply_gradients, global_sum


def normalize_court_targets(keypoints_xy, frame_wh: tuple[int, int]) -> torch.Tensor:
    """(..., K, 2) source-pixel keypoints -> (..., 2K) fp32 regression
    targets in [0, 1]."""
    kp = torch.as_tensor(np.asarray(keypoints_xy, np.float32))
    norm = kp / torch.tensor([frame_wh[0], frame_wh[1]], dtype=torch.float32)
    return norm.reshape(*norm.shape[:-2], norm.shape[-2] * 2)


def court_regression_loss(logits: torch.Tensor, targets: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """MSE over sigmoid(logits) (B, 2K) against targets; with mask (B, K) (1 =
    labelled) the weighted sum over the weights' sum (at least 1). Both
    normalizers are the global batch's with a mesh."""
    err = (torch.sigmoid(logits) - targets) ** 2
    if mask is None:
        n = global_sum(torch.tensor(float(err.numel()), device=err.device), mesh)
        return err.sum() / n
    w = torch.repeat_interleave(mask.float(), 2, dim=-1)
    return torch.sum(err * w) / torch.clamp(global_sum(w.sum(), mesh), min=1.0)


def court_loss(model, images, targets, mask=None, mesh=None) -> torch.Tensor:
    with batch_stats_over(model, mesh):
        logits = model(images)
    return court_regression_loss(logits, targets, mask, mesh)


def make_court_train_step(mesh=None) -> Callable:
    """(state, images (B, H, W, 3) ImageNet-normalised, targets (B, 2K),
    mask (B, K) or None) -> (state, the global loss)."""

    def train_step(state: TrainState, images, targets, mask=None):
        return apply_gradients(
            state, lambda: court_loss(state.model, images, targets, mask, mesh), mesh)

    return train_step
