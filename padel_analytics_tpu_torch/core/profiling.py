"""Stage timing, logging and device traces.

Counterpart of ``padel_analytics_tpu/core/profiling.py``:

- `StageTimer`: accumulating named-stage wall-clock timing that waits, at
  each stage's exit, for the device work of a value the stage made (CUDA
  launches return before the kernels end, so an unsynchronised clock
  would time the launches);
- `device_trace`: a context manager around `torch.profiler`, writing a
  Chrome trace that TensorBoard and Perfetto load;
- `log`: printing under a module-level verbosity switch.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch

VERBOSITY = 1  # 0 silent, 1 info, 2 debug


def log(msg: str, level: int = 1) -> None:
    if VERBOSITY >= level:
        print(msg)


class StageHandle:
    """Set `.value` to the stage's device output inside the body; the
    timer waits for it at exit."""

    value: Optional[object] = None


def _synchronize(value) -> None:
    """Wait for the CUDA devices that hold `value`'s tensors (a tensor, or
    a list, tuple or dict of them); nothing for host values."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _synchronize(v)


class StageTimer:
    """Accumulating named-stage wall-clock timer.

    Synchronizing on values produced INSIDE the stage body:

        with timer.stage("fwd") as s:
            s.value = model(x)

    `sync` may also be a value that already exists at entry, or a
    zero-arg callable evaluated at exit (for state the body mutates).
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: Optional[object] = None):
        handle = StageHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            target = handle.value
            if target is None:
                target = sync() if callable(sync) else sync
            _synchronize(target)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / self.counts[name], 3),
            }
            for name in self.totals
        }

    def dump(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block (host ops, and CUDA kernels where a card is
    present) with torch.profiler; writes `log_dir`/trace.json, a Chrome
    trace (TensorBoard, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
