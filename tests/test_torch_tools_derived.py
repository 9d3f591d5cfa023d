"""derived_quality (padel_analytics_tpu_torch/tools/derived_quality.py)
end to end on the CPU (its loops and evaluation against the JAX demo's:
tests/test_torch_tools_{data,train_yolo,eval_fused,eval_fused_derived}.py):

- run_demo(det_steps=1, pose_steps=2, device="cpu") serves every config
  (parity, fast, the two off-diagonal ones, a wire sweep) through the
  FusedPipeline on the CPU;
- two scales in one process: a scale-2 run between two scale-1 runs leaves
  the second equal to the first (the geometry is an argument, not module
  state, unlike the JAX demo's `_set_scale`).
"""

import math

import numpy as np
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu_torch.tools import derived_quality

pytest.importorskip("cv2")  # the scenes are drawn with OpenCV


def _finite(*values):
    return all(math.isfinite(v) for v in values)


def _derived(scale, **kw):
    return derived_quality.run_demo(det_steps=1, pose_steps=2, n_frames=8, n_train=8,
                                    verbose=False, device="cpu", scale=scale, **kw)


@pytest.fixture(scope="module")
def scale1():
    """Every config at scale 1, on one thread as the tests run (the autouse
    fixture is per test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _derived(1, isolate=True, wire_sweep=(72,))
    finally:
        torch.set_num_threads(threads)


def test_derived_quality_runs_end_to_end(scale1):
    assert list(scale1["grid"]) == ["parity", "fast", "derived_fullpose", "i420_halfpose",
                                    "fast_wire72"]
    for row in scale1["grid"].values():
        assert set(row) == {"detect_rate", "mean_iou", "kpt_px", "pose_match_rate"}
        assert 0.0 <= row["detect_rate"] <= 1.0 and 0.0 <= row["pose_match_rate"] <= 1.0
    assert _finite(scale1["det_loss"], scale1["pose_loss"])


def test_derived_quality_two_scales_in_one_process(scale1):
    other = _derived(2)
    again = _derived(1, isolate=True, wire_sweep=(72,))
    assert scale1["geometry"] == again["geometry"] == derived_quality.Geometry.at(1)
    assert other["geometry"].src_hw == (216, 384) and other["geometry"].det == 128
    assert other["eval"][0].shape == (8, 216, 384, 3)
    assert scale1["grid"] == again["grid"]
    assert (scale1["det_loss"], scale1["pose_loss"]) == (again["det_loss"], again["pose_loss"])
    for a, b in zip(scale1["eval"], again["eval"]):
        np.testing.assert_array_equal(a, b)
