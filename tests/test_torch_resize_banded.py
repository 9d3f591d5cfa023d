"""The port's block-banded resize (`ops/resize.py`: `_band_plan`, the
per-pass gate, `ResizePlan.apply(banded=True)`) against the JAX package's.

- The band plans (starts, W, n_tiles, B) are EQUAL, and so is every pass's
  choice of form at the fused path's plans, from 1920x1080 and from the
  'derived' ingest's 960x540 wire (read off the JAX package by tracing its
  `apply` and recording the banded branch's slices).
- Pillow plans: banded apply against the JAX package's banded apply, the
  uint8 results equal or one step apart where fp32 summation order moves a
  value across a .5 rounding boundary (at most 0.1% of the values, as
  tests/test_torch_preprocess.py records for the dense form).
- cv2-linear plans (two taps a row): banded EQUAL to dense, whatever the
  summation order, since adding the band's zero weights is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.ops import resize as jres
from padel_analytics_tpu_torch.ops import resize


def _u8(x):
    return np.clip(np.floor(np.asarray(x) + 0.5), 0, 255).astype(np.uint8)


# (src, dst, method) of the fused path's resize passes: the pose squash at
# 1280 and 640, the ball resize to 288x512 and the players' letterbox, from
# the source at 1080p and from the 960x540 'derived' wire.
FUSED_PLANS = [(src, dst, m) for src in ((1080, 1920), (540, 960)) for dst, m in (
    ((1280, 1280), "pil_bicubic"), ((640, 640), "pil_bicubic"), ((288, 512), "pil_bicubic"),
    ((360, 640), "cv2_linear"))]


def _jax_forms(src, dst, method, **kw) -> tuple[str, str]:
    """The JAX package's form of each pass ('dense' or 'banded'; horizontal
    first), from the axes its banded branch slices while `apply` traces."""
    axes = []
    real = jax.lax.slice_in_dim

    def record(x, start, limit, stride=1, axis=0):
        axes.append(axis)
        return real(x, start, limit, stride, axis)

    jax.lax.slice_in_dim = record
    try:
        plan = jres.resize_plan(src, dst, method)
        jax.make_jaxpr(lambda x: plan.apply(x, **kw))(
            jax.ShapeDtypeStruct((1, *src, 3), jnp.float32))
    finally:
        jax.lax.slice_in_dim = real
    return tuple("banded" if axis in axes else "dense" for axis in (-2, -3))


@pytest.mark.parametrize("src,dst,method", FUSED_PLANS)
def test_band_plan_and_gate_match_jax(src, dst, method):
    plan = resize.resize_plan(src, dst, method)
    jplan = jres.resize_plan(src, dst, method)
    for axis, (r, jr) in (("w", (plan.r_w, jplan.r_w)), ("h", (plan.r_h, jplan.r_h))):
        np.testing.assert_array_equal(r, jr)
        starts, w, n_tiles, band = plan.band_plan(axis)
        j_starts, j_w, j_n, j_band = jres._band_plan(np.asarray(jr), 128)
        np.testing.assert_array_equal(starts, j_starts)
        np.testing.assert_array_equal(w, j_w)
        assert (n_tiles, band) == (j_n, j_band)
    assert plan.forms() == _jax_forms(src, dst, method)
    assert plan.forms(banded=False) == ("dense", "dense")


def test_the_pose_squash_from_1080p_is_banded_and_the_wire_plans_dense():
    """What the gate decides at the fused path's plans: both passes of the
    squash to 1280 clear it, from 1080p (dense MACs 9x and 10x the banded)
    and from the 960x540 wire; every other plan stays dense, the fast plan's
    pose@640 squash, letterbox and ball resize from the wire included."""
    forms = {(src, dst): resize.resize_plan(src, dst, m).forms() for src, dst, m in FUSED_PLANS}
    assert forms[(1080, 1920), (1280, 1280)] == ("banded", "banded")
    assert forms[(540, 960), (1280, 1280)] == ("banded", "banded")
    assert all(v == ("dense", "dense") for k, v in forms.items() if k[1] != (1280, 1280))


@pytest.mark.parametrize("src,dst,tile,min_ratio", [
    ((54, 96), (90, 160), 16, 5.0), ((60, 80), (40, 30), 8, 1.5), ((135, 240), (160, 160), 16, 5.0),
    ((270, 480), (1280, 1280), 128, 5.0)])
def test_pil_banded_apply_matches_jax_banded(rng, src, dst, tile, min_ratio):
    kw = {"tile": tile, "min_ratio": min_ratio}
    plan = resize.resize_plan(src, dst, "pil_bicubic")
    assert plan.forms(**kw) == _jax_forms(src, dst, "pil_bicubic", **kw)
    assert "banded" in plan.forms(**kw)
    img = rng.integers(0, 256, (2, *src, 3)).astype(np.float32)
    got = _u8(plan.apply(torch.from_numpy(img), **kw).numpy())
    want = _u8(jres.resize_plan(src, dst, "pil_bicubic").apply(jnp.asarray(img), **kw))
    off = np.abs(got.astype(int) - want.astype(int))
    assert off.max(initial=0) <= 1
    assert int((off > 0).sum()) <= off.size // 1000


@pytest.mark.parametrize("src,dst,tile", [((96, 128), (40, 64), 8), ((120, 200), (70, 90), 16),
                                          ((1080, 1920), (360, 640), 64)])
def test_cv2_linear_banded_equals_dense(rng, src, dst, tile):
    plan = resize.resize_plan(src, dst, "cv2_linear")
    assert plan.forms(tile=tile, min_ratio=1.0) == ("banded", "banded")
    img = torch.from_numpy(rng.integers(0, 256, (2, *src, 3)).astype(np.float32))
    banded = plan.apply(img, tile=tile, min_ratio=1.0)
    assert torch.equal(banded, plan.apply(img, banded=False))
    want = jres.resize_plan(src, dst, "cv2_linear").apply(jnp.asarray(img.numpy()), tile=tile,
                                                          min_ratio=1.0)
    np.testing.assert_allclose(banded.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def test_banded_operands_upload_once(rng, monkeypatch):
    """The band indices and matrices reach the device once a plan and form,
    like the dense matrices; a later apply uploads nothing."""
    cached = resize.resize_plan((40, 30), (96, 96), "pil_bicubic")
    plan = resize.ResizePlan(cached.r_h, cached.r_w, cached.quantize_intermediate)
    kw = {"tile": 16, "min_ratio": 1.0}
    assert plan.forms(**kw) == ("banded", "banded")
    img = torch.from_numpy(rng.integers(0, 256, (1, 40, 30, 3)).astype(np.float32))
    calls = []
    real = torch.as_tensor
    monkeypatch.setattr(resize.torch, "as_tensor",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    first = plan.apply(img, **kw)
    ops = plan.upload("cpu", **kw)
    second = plan.apply(img, **kw)
    assert len(calls) == 4  # index and W of each pass, once
    assert plan.upload("cpu", **kw) is not None and ops[0][0] == "banded"
    assert torch.equal(first, second)
