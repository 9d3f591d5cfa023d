"""Stage timing, the run recorder, logging and device traces.

Counterpart of ``padel_analytics_tpu/core/profiling.py``:

- `tracer`: the port's one record of where a clip's time goes. Each clip
  (one `TrackingRunner.run()`, or a `FusedPipeline` entry point called on
  its own) opens a `RunRecord` (`tracer.run(frames)`); named spans
  (`tracer.span(name)`, or `traced(name)` around a function) add to the
  thread's current one (`tracer.bind` hands it to a worker thread).
  `tracer.runs` keeps the last `KEPT_RUNS` records in memory; nothing is
  written. While `torch.profiler` records, each span of the thread that
  started it is also a host op of the trace of its name, so a trace names
  the host's intervals by the program's spans, on the clock of the kernels
  and copies;
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
import functools
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Optional

import torch

VERBOSITY = 1  # 0 silent, 1 info, 2 debug
#: Run records `tracer.runs` keeps.
KEPT_RUNS = 256

_autograd_profiler = torch.autograd.profiler
_profiler = torch._C._profiler


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


class Span:
    """One named interval of a run: `name`, `start_ns` and `end_ns`
    (`time.perf_counter_ns`), `parent` (the span that was open on the same
    thread at entry, or None) and `thread` (its ident). A context manager
    (`Tracer.span`); at exit it is appended to the run that was current
    when it was made."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "_run", "_range")

    def __init__(self, name: str):
        self.name = name

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        self.thread = threading.get_ident()
        self.parent = getattr(_open_spans, "top", None)
        _open_spans.top = self
        self._range = None
        # Checked per span: entering a range costs even with no profiler
        # running. A function-scope range, not `record_function`: the
        # profiler projects a user-scope range onto the device as an event
        # over its kernels, which a trace's reader takes for device work.
        if _autograd_profiler._is_profiler_enabled:
            self._range = _profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _open_spans.top = self.parent
        if self._run is not None:
            self._run.spans.append(self)  # atomic: no lock across threads


_open_spans = threading.local()


class RunRecord:
    """What one clip recorded: its `frames` and its `spans` in the order
    they ended."""

    __slots__ = ("id", "frames", "spans")

    def __init__(self, run_id: int, frames: int):
        self.id = run_id
        self.frames = frames
        self.spans: list[Span] = []

    def seconds(self, name: str) -> float:
        """The summed seconds of the spans called `name`."""
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name == name) / 1e9


class Tracer:
    """The process's run records (`runs`, the newest last) and each
    thread's current one, which the thread's spans add to: the last run the
    thread opened, or the one a function was bound to (`bind`) for a call
    on a worker thread. A span that starts after its run closed
    (`TrackingRunner.write_csv`) still joins it; one on a thread with no
    current run is dropped. Runs opened on two threads are two records."""

    def __init__(self, keep: int = KEPT_RUNS):
        self.runs: deque[RunRecord] = deque(maxlen=keep)
        self._local = threading.local()  # this thread's `run` and open `depth`
        self._ids = itertools.count(1)

    @property
    def current(self) -> Optional[RunRecord]:
        """This thread's current run."""
        return getattr(self._local, "run", None)

    @contextlib.contextmanager
    def run(self, frames: int):
        """Open the record of a clip of `frames` frames for the block and
        yield it; inside a block already open on this thread (a pipeline
        under its runner) yield the open one."""
        local = self._local
        depth = getattr(local, "depth", 0)
        if not depth:
            local.run = RunRecord(next(self._ids), frames)
            self.runs.append(local.run)
        local.depth = depth + 1
        try:
            yield local.run
        finally:
            local.depth = depth

    def bind(self, fn):
        """`fn`, whose spans join this thread's current run on whichever
        thread it is called (a prefetch worker, the drawer)."""
        run = self.current

        @functools.wraps(fn)
        def bound(*args, **kwargs):
            local = self._local
            saved = getattr(local, "run", None)
            local.run = run
            try:
                return fn(*args, **kwargs)
            finally:
                local.run = saved
        return bound

    def span(self, name: str) -> Span:
        span = Span(name)
        span._run = self.current
        return span


tracer = Tracer()


def traced(name: str):
    """Decorate a function so that each call is the span `name` of the
    current run."""
    def decorate(fn):
        @functools.wraps(fn)
        def run_traced(*args, **kwargs):
            with tracer.span(name):
                return fn(*args, **kwargs)
        return run_traced
    return decorate
