"""A model resident on its device for the whole run.

Counterpart of ``padel_analytics_tpu/trackers/_engine.py``. PyTorch runs
eagerly, so there is no cache of compiled steps: an `Engine` is the model
in eval mode on its device, with its weights.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn


class Engine:
    """Model + device + weights."""

    def __init__(self, model: nn.Module, device: torch.device | str,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None):
        self.device = torch.device(device)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @property
    def state_dict(self) -> dict[str, torch.Tensor]:
        return self.model.state_dict()


def pad_batch(arr: torch.Tensor, batch: int) -> tuple[torch.Tensor, int]:
    """Zero-pad the leading axis up to `batch`; returns (padded, n_real)."""
    n = arr.shape[0]
    if n == batch:
        return arr, n
    pad = arr.new_zeros((batch - n,) + tuple(arr.shape[1:]))
    return torch.cat([arr, pad], dim=0), n
