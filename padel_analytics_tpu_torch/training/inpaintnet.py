"""InpaintNet training: the masked-coordinate loss and the train step.

Counterpart of ``padel_analytics_tpu/training/inpaintnet.py``: the model
predicts the ground-truth normalised coordinates; the inpainted (masked)
region carries weight 1, the rest 0.1 (keeping the identity path stable).
InpaintNet has no BatchNorm.
"""

from __future__ import annotations

from typing import Callable

import torch

from .state import TrainState, apply_gradients, global_sum


def masked_coordinate_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                           unmasked_weight: float = 0.1, mesh=None) -> torch.Tensor:
    """pred, target (B, L, 2), mask (B, L, 1) (1 = inpainted region): the
    weighted squared error over the weights' sum (the global batch's, this
    rank's share of the loss with a mesh)."""
    se = torch.sum((pred - target) ** 2, dim=-1, keepdim=True)
    w = mask + unmasked_weight * (1.0 - mask)
    return torch.sum(se * w) / torch.clamp(global_sum(w.sum(), mesh), min=1e-6)


def inpaintnet_loss(model, coords, mask, target, mesh=None) -> torch.Tensor:
    return masked_coordinate_loss(model(coords, mask), target, mask, mesh=mesh)


def make_inpaintnet_train_step(mesh=None) -> Callable:
    """(state, coords (B, L, 2), mask (B, L, 1), target (B, L, 2)) -> (state,
    the global loss)."""

    def train_step(state: TrainState, coords, mask, target):
        return apply_gradients(
            state, lambda: inpaintnet_loss(state.model, coords, mask, target, mesh), mesh)

    return train_step
