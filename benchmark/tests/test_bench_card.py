"""A whole run on the card (one short window): its
result line keeps to the contract. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from benchmark.tests._tiny import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ref_1080p_rally",
                          "--seed", str(2**31 + 99), "--seconds", "1", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "compared"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    want = ({"collect_ms_per_frame", "launches_per_frame", "mfu_pct", "k1_roofline_pct",
             "idle_pct"} if trace else {"fps", "setup_s"})
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert all(0 < result["metrics"][k]["value"] <= 100 for k in ("mfu_pct",
                                                                      "k1_roofline_pct"))
