"""Temporal overlap-ensemble for stride-1 sliding windows.

Counterpart of ``padel_analytics_tpu/ops/ensemble.py``: the host-side
coefficient tables, the whole-clip `ensemble_full` and the chunk-fed
`StreamingEnsembler` (plain torch on the predictions' device; the fused
pipeline and the ball tracker carry their own rolling ensemble in the
window step, and the sharded window inference its own). Semantics, with
N_w = num_frames - L + 1 windows:

- frame f < L-1 (head):      uniform mean over the f+1 covering windows;
- L-1 <= f <= N_w-1 (body):  triangular weights over all L windows;
- f > N_w-1 (tail):          1 / (N_w + L - 1 - f) over the covering
                             windows, the reference's quirk included.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def get_ensemble_weight(seq_len: int, eval_mode: str = "weight") -> np.ndarray:
    """Positional ensemble weights ('weight': triangular, 'average')."""
    if eval_mode == "average":
        weight = np.ones(seq_len) / seq_len
    elif eval_mode == "weight":
        weight = np.ones(seq_len)
        for i in range(math.ceil(seq_len / 2)):
            weight[i] = i + 1
            weight[seq_len - i - 1] = i + 1
        weight = weight / weight.sum()
    else:
        raise ValueError("Invalid mode")
    return weight.astype(np.float32)


def overlap_ensemble_coefficients(
    num_frames: int, seq_len: int, eval_mode: str = "weight"
) -> np.ndarray:
    """(num_frames, seq_len) table C with
    ``out[f] = sum_j C[f, j] * Y[f - (L-1) + j, (L-1) - j]``, Y the window
    predictions zero-padded outside [0, N_w)."""
    num_windows = num_frames - seq_len + 1
    if num_windows < 1:
        raise ValueError("clip shorter than seq_len")
    weight = get_ensemble_weight(seq_len, eval_mode)
    coef = np.zeros((num_frames, seq_len), dtype=np.float32)
    for f in range(num_frames):
        valid = np.array(
            [0 <= f - (seq_len - 1) + j < num_windows for j in range(seq_len)]
        )
        if f > num_windows - 1:
            coef[f, valid] = 1.0 / (num_windows + seq_len - 1 - f)
        elif f < seq_len - 1:
            coef[f, valid] = 1.0 / valid.sum()
        else:
            coef[f] = weight
    return coef


def _weighted_sum(gathered: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """sum_j coef[:, j] * gathered[:, j] over (F, L, ...) x (F, L)."""
    c = coef.reshape(tuple(coef.shape) + (1,) * (gathered.dim() - 2))
    return torch.sum(gathered * c, dim=1)


def ensemble_full(window_preds: torch.Tensor, coefficients: torch.Tensor,
                  seq_len: int) -> torch.Tensor:
    """Whole-clip ensemble of (N_w, L, ...) window predictions with a
    (num_frames, L) coefficient table: (num_frames, ...) on the
    predictions' device."""
    num_frames = coefficients.shape[0]
    l = seq_len
    dev = window_preds.device
    pad = window_preds.new_zeros((l - 1,) + tuple(window_preds.shape[1:]))
    padded = torch.cat([pad, window_preds, pad], dim=0)
    # Padded window index of (f, j): f + j (w = f - (L-1) + j, L-1 pad rows).
    j_ids = torch.arange(l, device=dev)
    w_idx = torch.arange(num_frames, device=dev)[:, None] + j_ids[None, :]
    gathered = padded[w_idx, (l - 1) - j_ids[None, :]]  # (num_frames, L, ...)
    return _weighted_sum(gathered, coefficients.to(dev, torch.float32))


class StreamingEnsembler:
    """Chunk-fed variant: consume consecutive window predictions and emit the
    ensembled frames each chunk completes, carrying the last L-1 windows
    (O(L * chunk) memory)."""

    def __init__(self, num_frames: int, seq_len: int, eval_mode: str = "weight"):
        self.num_frames = num_frames
        self.seq_len = seq_len
        self.num_windows = num_frames - seq_len + 1
        self.coefficients = torch.from_numpy(
            overlap_ensemble_coefficients(num_frames, seq_len, eval_mode))
        self._carry: torch.Tensor | None = None  # the last L-1 windows
        self._emitted = 0  # frames emitted so far (one per window consumed)

    def _emit(self, buf: torch.Tensor, n: int) -> torch.Tensor:
        """Frames [emitted, emitted + n) from `buf`, whose row r holds window
        emitted - (L-1) + r."""
        l = self.seq_len
        dev = buf.device
        j_ids = torch.arange(l, device=dev)
        rows = torch.arange(n, device=dev)[:, None] + j_ids[None, :]
        gathered = buf[rows, (l - 1) - j_ids[None, :]]
        coef = self.coefficients[self._emitted: self._emitted + n].to(dev)
        self._emitted += n
        return _weighted_sum(gathered, coef)

    def update(self, window_preds: torch.Tensor) -> torch.Tensor:
        """Feed (B, L, ...) consecutive window predictions; returns the B
        frames they complete, (B, ...)."""
        l = self.seq_len
        if self._carry is None:
            self._carry = window_preds.new_zeros((l - 1,) + tuple(window_preds.shape[1:]))
        b = window_preds.shape[0]
        if self._emitted + b > self.num_windows:
            raise ValueError(f"{self._emitted + b} windows fed for {self.num_windows}")
        buf = torch.cat([self._carry, window_preds], dim=0)
        self._carry = buf[-(l - 1):]
        return self._emit(buf, b)

    def finalize(self) -> torch.Tensor:
        """The trailing L-1 frames (the tail's uniform averaging)."""
        if self._carry is None or self._emitted != self.num_windows:
            raise ValueError(f"{self._emitted} windows fed for {self.num_windows}")
        n_tail = self.num_frames - self._emitted
        buf = torch.cat([self._carry, torch.zeros_like(self._carry)], dim=0)
        return self._emit(buf, n_tail)
