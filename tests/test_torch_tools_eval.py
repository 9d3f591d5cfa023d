"""The harness's TrackNet and InpaintNet demos against the JAX demos'
(tools/convergence_demo.py, tools/inpaint_convergence_demo.py), each JAX
demo run once with its own loop, its own init and its real jitted step
(the step's arguments, its first loss and its final state recorded):

- one step of the port's loop (convergence and stride_quality share it;
  inpaint_convergence's) from the JAX demo's initial variables, carried
  across (models/convert.py::state_dict_from_flax), gives the JAX step's
  first loss within the bound of tests/_torch_train.py::assert_losses
  (1e-5 relative);
- on the JAX demo's variables after 20 TrackNet steps (no metric at its
  floor), decode_positions gives the JAX demo's decoded ints frame for
  frame (kernel K2's plain version against the JAX decode) and evaluate its
  metrics exactly; after 50 InpaintNet steps, masked_px_error is within
  1e-6 of the JAX demo's (relative); both in fp32 on the CPU.

The JAX demos evaluate with model.apply unjitted; here it is jitted
(`JitApply`), the same function in one dispatch. The YOLOv8n demos:
tests/test_torch_tools_eval_yolo.py, test_torch_tools_eval_fused.py and
test_torch_tools_train_yolo.py.
"""

import numpy as np
import pytest

import _torch_tools_jax as tj
import tools.convergence_demo as jconv
import tools.inpaint_convergence_demo as jinp
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_train import assert_losses
from padel_analytics_tpu.models.tracknet import InpaintNet as JaxInpaintNet
from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu.training import inpaintnet as jin
from padel_analytics_tpu.training import tracknet as jtn
from padel_analytics_tpu_torch.models.tracknet import InpaintNet, make_tracknet
from padel_analytics_tpu_torch.tools import convergence, inpaint_convergence

pytest.importorskip("cv2")  # the scenes are drawn with OpenCV

METRIC_RTOL = 1e-6
# The demos' own evaluations, kept before the runs below stub them out.
JAX_EVALUATE, JAX_MASKED_PX_ERROR = jconv.evaluate, jinp.masked_px_error


def _run(module, name, run, stubs):
    """The JAX demo run with its own loop and the real step, its
    evaluations stubbed; the recorder."""
    rec = tj.Recorder(make_real=getattr(module, name))
    with pytest.MonkeyPatch.context() as mp:
        tj.patch_jit(mp)
        mp.setattr(module, name, rec.factory)
        for (obj, attr), value in stubs.items():
            mp.setattr(obj, attr, value)
        run()
    return rec


@pytest.fixture(scope="module")
def tracknet_run():
    return _run(jtn, "make_tracknet_train_step",
                lambda: jconv.run_demo(steps=20, n=72, verbose=False, force_cpu=False),
                {(jtn, "init_train_state"): tj.init_state, (jconv, "evaluate"): lambda *a: {}})


@pytest.fixture(scope="module")
def inpaint_run():
    return _run(jin, "make_inpaintnet_train_step",
                lambda: jinp.run_demo(steps=50, verbose=False, force_cpu=False),
                {(jinp, "masked_px_error"): lambda *a: 0.0})


def test_tracknet_first_step_equals_jax(monkeypatch, tracknet_run):
    monkeypatch.setattr(convergence, "evaluate", lambda *a: {})
    out = convergence.run_demo(steps=1, n=72, verbose=False, device="cpu",
                               init=tj.to_port(tj.variables(tracknet_run.first_state)))
    assert_losses(out["losses"], tracknet_run.losses[:1])


def test_tracknet_evaluation_equals_jax(tracknet_run):
    variables = tj.variables(tracknet_run.state)
    clip = convergence.make_rally(72, 48, 80, np.random.default_rng(0))
    jmodel = tj.JitApply(jax_make_tracknet(8, "concat")[0])
    want_idx, want = jconv.decode_positions(jmodel, variables, clip, 8, 4)
    model, _ = make_tracknet(8, "concat")
    model.load_state_dict(tj.to_port(variables))
    got_idx, got = convergence.decode_positions(model, clip, 8)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got, want)
    found = (got[:, 0] >= 0).sum()
    assert 0 < found < len(got)  # neither at its floor nor at its ceiling
    want_m = JAX_EVALUATE(jmodel, variables, clip, 8, 4)
    assert convergence.evaluate(model, clip, 8) == want_m
    assert want_m["within_4px"] > 0


def test_inpaintnet_first_step_equals_jax(monkeypatch, inpaint_run):
    monkeypatch.setattr(inpaint_convergence, "masked_px_error", lambda *a: 0.0)
    out = inpaint_convergence.run_demo(steps=1, verbose=False, device="cpu",
                                       init=tj.to_port({"params": inpaint_run.first_state.params}))
    assert_losses(out["losses"], inpaint_run.losses[:1])


def test_inpaint_evaluation_equals_jax(inpaint_run):
    params = inpaint_run.state.params
    _, rally, _ = inpaint_convergence.make_rallies(400)
    want = JAX_MASKED_PX_ERROR(tj.JitApply(JaxInpaintNet()), params, rally)
    model = InpaintNet()
    model.load_state_dict(tj.to_port({"params": params}))
    got = inpaint_convergence.masked_px_error(model, rally)
    assert 0 < want < 250  # trained: below the untrained ~260-290 px
    assert abs(got - want) <= METRIC_RTOL * want, (got, want)
