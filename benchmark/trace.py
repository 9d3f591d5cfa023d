"""Reading `torch.profiler`'s trace of a traced clip: device busy time as
the union of every kernel and copy interval over all streams, the idle
gaps between them and what the host was doing in each, device time by
kernel name, and the host's launch calls. Also the K1 call recorder, which
sees the shapes the port hands its conv kernel.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass, field

import torch

#: Host calls that put work on the device: kernels, graphs, async copies.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync")


def union(intervals) -> tuple[float, list[tuple[float, float]]]:
    """(length covered by the union of (start, end) intervals, the gaps
    between the merged intervals as (start, length)), in the intervals'
    unit."""
    busy, gaps, cur = 0.0, [], None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a - cur[1]))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


@dataclass
class Trace:
    """What the traced window holds. Times in seconds."""

    window_s: float
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)  # device time by op name
    launches: int = 0
    gaps: list = field(default_factory=list)  # (seconds, what the host was doing)

    def kernel_time(self, key: str) -> float:
        return sum(s for name, s in self.kernel_s.items() if key in name)


def read_profile(prof, window_s: float) -> Trace:
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda]
    host = [e for e in events if e.device_type != cuda]
    t = Trace(window_s=window_s)
    if not dev:
        return t
    busy_us, gaps = union((e.time_range.start, e.time_range.end) for e in dev)
    t.busy_s = busy_us / 1e6
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us() / 1e6
    t.kernel_s = dict(by_name)
    t.launches = sum(e.name in LAUNCH_CALLS for e in host)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host)
    for at, us in sorted(gaps, key=lambda g: -g[1])[:10]:
        mid = at + us / 2
        # The innermost host op running at the gap's middle.
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        what = max(inner, key=lambda s: s[0])[2] if inner else "no host op recorded"
        t.gaps.append((us / 1e6, what))
    return t


def breakdown(t: Trace) -> dict:
    """The result line's `breakdown`: the 10 device ops that took most time
    and the 10 longest idle gaps, by what the host was doing."""
    ops = sorted(t.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:120], s] for name, s in ops],
            "idle_gaps": [[what[:120], s] for s, what in t.gaps]}


class K1Recorder:
    """Inside the block, every attribute of the port's loaded modules that
    is its K1 entry (`ops.conv3x3.conv3x3_bn_act_packed`) is a wrapper that
    records each call's (B, H, W, Cin, Cout) before it launches: unpadded,
    as the caller asks for it."""

    def __init__(self, package: str):
        self.package = package
        self.calls: list[tuple[int, int, int, int, int]] = []
        self._saved: list = []

    def __enter__(self):
        entry = sys.modules[f"{self.package}.ops.conv3x3"].conv3x3_bn_act_packed

        def recorded(x, wk, scale, bias, *args, **kwargs):
            self.calls.append((*x.shape[:3], x.shape[3], scale.numel()))
            return entry(x, wk, scale, bias, *args, **kwargs)

        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] == self.package and \
                    getattr(mod, "conv3x3_bn_act_packed", None) is entry:
                self._saved.append((mod, entry))
                mod.conv3x3_bn_act_packed = recorded
        return self

    def __exit__(self, *exc):
        for mod, entry in self._saved:
            mod.conv3x3_bn_act_packed = entry
        self._saved.clear()
