"""The fused pipeline's device plumbing: CUDA streams and events, pinned
staging buffers for the upload, pinned buffers for the downloads, and a
device timer.

Every helper takes the pipeline's device. On a CUDA device the work runs
asynchronously on its own streams, ordered by events; on the CPU (the
tests) streams and events are None and everything runs in program order.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ..core.profiling import tracer


class Lanes:
    """One CUDA stream for the upload (and the ingest decode behind it) and
    one for each sub-step (det, pose, ball, and a model court's)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.copy, self.det, self.pose, self.ball, self.court = (
            torch.cuda.Stream(self.device) if cuda else None for _ in range(5)
        )

    def all(self) -> tuple:
        return (self.copy, self.det, self.pose, self.ball, self.court)

    @staticmethod
    def on(stream):
        """Make `stream` current (kernels K1 and K2 launch on the current
        stream); a no-op on the CPU."""
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    @staticmethod
    def record(stream) -> Optional[torch.cuda.Event]:
        """An event behind the work queued on `stream` so far."""
        if stream is None:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event

    @staticmethod
    def wait(stream, event) -> None:
        """Order `stream`'s later work after `event`."""
        if stream is not None and event is not None:
            stream.wait_event(event)

    def after_current(self) -> None:
        """Order every lane after the work queued on the current stream (the
        run's set-up: plans, medians, tables)."""
        if self.device.type == "cuda":
            current = torch.cuda.current_stream(self.device)
            for stream in self.all():
                stream.wait_stream(current)

    def current_after_all(self) -> None:
        """Order the current stream's later work after every lane's."""
        if self.device.type == "cuda":
            current = torch.cuda.current_stream(self.device)
            for stream in self.all():
                current.wait_stream(stream)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Queue `t`'s copy into fresh pinned host memory on the current stream
    (the caller records an event behind it and waits on that before
    reading); a CPU tensor is returned as it is."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class StagingRing:
    """Reused host buffers that chunks are packed into before their upload:
    pinned for a CUDA device, so each upload is one asynchronous copy. Chunk
    k uses slot k % slots; `acquire` hands a slot out for refilling only
    after the event recorded behind its last upload has completed."""

    def __init__(self, shape: tuple[int, ...], slots: int, device: torch.device):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.shape = tuple(shape)
        self._bufs = [torch.empty(self.shape, dtype=torch.uint8, pin_memory=pin)
                      for _ in range(slots)]
        self._events: list[Optional[torch.cuda.Event]] = [None] * slots

    def acquire(self, k: int) -> np.ndarray:
        """Chunk k's slot, as a numpy view, once its last upload is done (a
        wait that is the span `fused.slot_wait`)."""
        i = k % len(self._bufs)
        event = self._events[i]
        if event is not None:
            with tracer.span("fused.slot_wait"):
                event.synchronize()
        return self._bufs[i].numpy()

    @property
    def nbytes(self) -> int:
        """Host bytes of all the slots (pinned for a CUDA device)."""
        return sum(buf.numel() for buf in self._bufs)

    def upload(self, k: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Queue chunk k's slot's copy to the device on the current stream,
        into `out` (a device buffer of the slot's shape) where given;
        returns the device tensor. On the CPU, a copy of the slot."""
        i = k % len(self._bufs)
        buf = self._bufs[i]
        if self.device.type == "cpu":
            return buf.clone() if out is None else out.copy_(buf)
        dev = (buf.to(self.device, non_blocking=True) if out is None
               else out.copy_(buf, non_blocking=True))
        self._events[i] = Lanes.record(torch.cuda.current_stream(self.device))
        return dev


class DeviceTimer:
    """Elapsed device time of the work queued on the current stream between
    `start` and `stop` (CUDA events); host wall time on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self._start = None

    def start(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def stop(self) -> float:
        """Seconds since `start`; waits for the device."""
        if not self.cuda:
            return time.perf_counter() - self._start
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return self._start.elapsed_time(end) / 1e3
