"""Pieces the demos share: the device and serving dtype, OpenCV, the
shuffled batch order and the step timing."""

from __future__ import annotations

import argparse
import time
from typing import Iterator

import numpy as np
import torch


def require_cv2():
    """The cv2 module; ImportError naming OpenCV where it is absent (the
    demos draw and resize their scenes with it, as the JAX demos do)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the demos draw their synthetic scenes with OpenCV: "
                          "module cv2 is not installed") from e
    return cv2


def resolve_device(device) -> torch.device:
    """torch.device of `device`; RuntimeError for a CUDA device where there
    is none (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def serving_dtype(device) -> torch.dtype:
    """bf16 on the card (kernel K1 takes bf16), fp32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def shuffled_batches(rng: np.random.Generator, n: int, batch: int) -> Iterator[np.ndarray]:
    """Index batches forever: each epoch one `rng.permutation(n)` cut into
    `batch`-sized runs, the last one shorter where `batch` does not divide n
    (the JAX demos' loop)."""
    while True:
        order = rng.permutation(n)
        for lo in range(0, n, batch):
            yield order[lo: lo + batch]


class StepTimer:
    """Host wall time of each train step; every step ends in a download of
    its loss, so it has finished on the device when the clock stops."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.times.append(time.perf_counter() - self._t0)

    def median_ms(self, warmup: int = 2) -> float:
        """Median step ms after `warmup` steps (all steps where there are no
        more)."""
        t = self.times[warmup:] or self.times
        return float(np.median(t)) * 1e3 if t else float("nan")


def device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="train and serve on the card (default) or the CPU")
