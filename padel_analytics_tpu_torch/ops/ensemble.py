"""Temporal overlap-ensemble coefficients for stride-1 sliding windows.

Counterpart of ``padel_analytics_tpu/ops/ensemble.py`` (the host-side
tables; the streaming device ensemble itself lives in the ball tracker's
window step). Semantics, with N_w = num_frames - L + 1 windows:

- frame f < L-1 (head):      uniform mean over the f+1 covering windows;
- L-1 <= f <= N_w-1 (body):  triangular weights over all L windows;
- f > N_w-1 (tail):          1 / (N_w + L - 1 - f) over the covering
                             windows, the reference's quirk included.
"""

from __future__ import annotations

import math

import numpy as np


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
