"""The port's core/profiling.py against the JAX package's: the same stage
sequence gives StageTimer summaries with the same names and counts, the
same keys, and means that are total / count; `sync` as a value and as a
callable; `log` under VERBOSITY; `device_trace` writes a Chrome trace on
the CPU."""

import json

import jax.numpy as jnp
import pytest
import torch

from padel_analytics_tpu.core import profiling as jprof
from padel_analytics_tpu_torch.core import profiling

STAGES = ["decode", "model", "decode", "nms", "model", "model"]


def _run(module, make):
    timer = module.StageTimer()
    for name in STAGES:
        with timer.stage(name) as s:
            s.value = make()
    with timer.stage("sync_value", sync=make()):
        pass
    with timer.stage("sync_callable", sync=make):
        pass
    return timer


def test_summary_names_and_counts_equal_jax():
    got = _run(profiling, lambda: torch.ones(4) * 2).summary()
    want = _run(jprof, lambda: jnp.ones(4) * 2).summary()
    assert list(got) == list(want)
    for name, rec in got.items():
        assert rec.keys() == want[name].keys()
        assert rec["count"] == want[name]["count"]
        # total_s is rounded to 0.1 ms, mean_ms to 1 us, both from the sum.
        assert rec["total_s"] >= 0 and rec["mean_ms"] == pytest.approx(
            1000 * rec["total_s"] / rec["count"], abs=0.051)


def test_sync_value_and_callable():
    timer = profiling.StageTimer()
    made = []

    def sync():
        made.append(torch.zeros(2))
        return {"a": [made[-1], (made[-1],)], "b": 3}  # nested containers and host values

    with timer.stage("callable", sync=sync):
        pass
    with timer.stage("value", sync=torch.zeros(3)):
        pass
    with timer.stage("none"):
        pass
    assert len(made) == 1  # the callable runs once, at the stage's exit
    assert {k: v["count"] for k, v in timer.summary().items()} == {
        "callable": 1, "value": 1, "none": 1}
    assert json.loads(timer.dump()) == timer.summary()


def test_log_verbosity(capsys, monkeypatch):
    profiling.log("shown")
    profiling.log("debug", level=2)
    monkeypatch.setattr(profiling, "VERBOSITY", 2)
    profiling.log("debug now", level=2)
    assert capsys.readouterr().out.splitlines() == ["shown", "debug now"]


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
