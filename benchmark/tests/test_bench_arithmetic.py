"""The yardstick's arithmetic: the union and idle share of device
intervals, K1's bound, the FLOP counter, and the metric readers."""

import math
import sys
import types

import pytest
import torch

from benchmark import flops, trace
from benchmark.cell import Record
from benchmark.metrics import idle_pct, k1_roofline_pct, launches_per_frame, mfu_pct
from benchmark.reference import models


def test_union_merges_overlaps_across_streams():
    busy, gaps = trace.union([(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)])
    assert busy == 12 + 10 + 1
    assert gaps == [(12, 8), (30, 10)]
    assert trace.union([]) == (0.0, [])


def test_idle_share_of_a_window():
    rec = Record(trace=trace.Trace(window_s=2.0, busy_s=1.5))
    assert idle_pct.read(rec) == pytest.approx(25.0)
    assert idle_pct.read(Record()) is None


def test_k1_bound_takes_the_larger_of_flops_and_bytes():
    b, h, w, cin, cout = 16, 288, 512, 64, 64
    m = b * h * w
    flop_s = 2 * m * cout * 9 * cin / 989e12
    byte_s = (2 * m * cin + 2 * 9 * cin * cout + 8 * cout + 2 * m * cout) / 3.35e12
    assert flops.k1_bound_s(b, h, w, cin, cout) == max(flop_s, byte_s)
    assert flops.k1_bound_s(1, 8, 8, 8, 8) == pytest.approx(
        (2 * 64 * 8 + 2 * 9 * 64 + 64 + 2 * 64 * 8) / 3.35e12)


def test_k1_roofline_reader_and_launches():
    t = trace.Trace(window_s=1.0, busy_s=0.5, kernel_s={"conv3x3_bn_act_sm90<64, 64>": 0.002,
                                                        "other": 1.0}, launches=300)
    calls = [(16, 288, 512, 64, 64)] * 2
    rec = Record(clips=[{"frames": 30, "seconds": 1.0, "collect_s": 0.0, "traced": True}],
                 trace=t, k1_calls=calls)
    assert k1_roofline_pct.read(rec) == pytest.approx(
        100 * 2 * flops.k1_bound_s(*calls[0]) / 0.002)
    assert launches_per_frame.read(rec) == 10.0


def test_yolov8m_detect_flops_match_ultralytics():
    """ultralytics publishes 78.9 GFLOPs for yolov8m at 640 (80 classes)."""
    got = flops.conv_flops(models.YOLOv8("m", 80), (1, 640, 640, 3)) / 1e9
    assert abs(got - 78.9) / 78.9 < 0.03, got


def test_mfu_reader_uses_untraced_clips():
    rec = Record(clips=[{"frames": 300, "seconds": 3.0, "collect_s": 0.1, "traced": True},
                        {"frames": 300, "seconds": 2.0, "collect_s": 0.1, "traced": False}],
                 flops_per_frame={"a": 1e12, "b": 0.5e12})
    assert mfu_pct.read(rec) == pytest.approx(100 * 1.5e12 * 300 / (2.0 * 989e12))


def test_k1_recorder_wraps_and_restores_every_binding(monkeypatch):
    entry = lambda x, wk, scale, bias, act="silu": x  # noqa: E731
    ops = types.ModuleType("pkgx.ops.conv3x3")
    ops.conv3x3_bn_act_packed = entry
    user = types.ModuleType("pkgx.models.layers")
    user.conv3x3_bn_act_packed = entry
    other = types.ModuleType("pkgxy.models")
    other.conv3x3_bn_act_packed = entry
    for m in (ops, user, other):
        monkeypatch.setitem(sys.modules, m.__name__, m)
    x = torch.zeros((2, 4, 6, 3))
    with trace.K1Recorder("pkgx") as rec:
        user.conv3x3_bn_act_packed(x, None, torch.zeros(40), None)
        assert other.conv3x3_bn_act_packed is entry  # another package, whole-name compare
    assert rec.calls == [(2, 4, 6, 3, 40)]
    assert user.conv3x3_bn_act_packed is entry and ops.conv3x3_bn_act_packed is entry
    assert math.isfinite(flops.PEAK_BF16_FLOPS)
