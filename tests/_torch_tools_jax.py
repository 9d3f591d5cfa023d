"""Shared pieces of the harness's parity tests (tests/test_torch_tools_*.py):
the JAX demos (repository-level tools/*_demo.py) driven as they run, with
their train steps observed.

A `Recorder` stands in for a JAX demo's train-step factory (`make_*_train_
step`, looked up in its module when the demo runs): each step's arguments
are kept as numpy, the first step's state too; with `real=True` the real
step, jitted, runs and its losses and final state are kept. `jax.jit`
passes a recorder's step through unjitted (`patch_jit`), so it sees arrays,
not tracers. `PortRecorder` does the same for the port's loops.

`jit_init` is the demos' `init_train_state` / `init_yolo_train_state` /
`model.init` compiled once: the same PRNGKey(0) draws as the demos' eager
init, equal to it value for value (checked once for TrackNet 48x80 and
YOLOv8n 64x64), in a fraction of the time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from padel_analytics_tpu.models.yolov8 import anchor_table
from padel_analytics_tpu.training import tracknet as jtn
from padel_analytics_tpu.training import yolo as jyolo
from padel_analytics_tpu_torch.models.convert import state_dict_from_flax

REAL_JIT = jax.jit


class Stop(Exception):
    """Raised by a recorder after its last step, to end a demo's loop."""


class Recorder:
    def __init__(self, make_real=None, steps=None):
        self.make_real = make_real  # the real step factory, or None: steps do nothing
        self.steps = steps  # raise Stop on the step after these many
        self.args = []  # each step's arguments, numpy
        self.hw = []  # the image size of each step's factory (YOLO)
        self.first_state = None
        self.model = None  # the model the factory was given
        self.losses = []
        self.state = None

    def factory(self, *fargs, **fkw):
        real = REAL_JIT(self.make_real(*fargs, **fkw)) if self.make_real else None
        hw = fargs[2] if len(fargs) > 2 else None
        self.model = fargs[0]

        def step(state, *args):
            if self.steps is not None and len(self.args) >= self.steps:
                raise Stop
            if not self.args:
                self.first_state = state
            self.args.append(tuple(np.asarray(a) for a in args))
            self.hw.append(hw)
            if real is None:
                return state, 0.0
            state, loss = real(state, *args)
            self.losses.append(float(loss))
            self.state = state
            return state, loss

        step.recorder = True
        return step


def record_yolo(monkeypatch, run):
    """(the initial state, the first batch, the model and image size its
    step factory was given) of a JAX demo's YOLO loop, run until its second
    step with the demos' own init (`init_state`)."""
    import pytest

    rec = Recorder(steps=1)
    patch_jit(monkeypatch)
    monkeypatch.setattr(jyolo, "make_yolo_train_step", rec.factory)
    monkeypatch.setattr(jyolo, "init_yolo_train_state", init_state)
    with pytest.raises(Stop):
        run()
    return rec.first_state, rec.args[0], rec.model, rec.hw[0]


def run_yolo(monkeypatch, run):
    """A JAX demo's YOLO loop run with the real step from the demos' own
    init (`init_state`); the recorder."""
    rec = Recorder(make_real=jyolo.make_yolo_train_step)
    patch_jit(monkeypatch)
    monkeypatch.setattr(jyolo, "make_yolo_train_step", rec.factory)
    monkeypatch.setattr(jyolo, "init_yolo_train_state", init_state)
    run()
    return rec


def patch_jit(monkeypatch) -> None:
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f if getattr(f, "recorder", False)
                        else REAL_JIT(f, *a, **k))


class PortRecorder:
    """Stands in for the port's step factory: keeps each step's arguments
    (numpy) and returns the state unchanged."""

    def __init__(self):
        self.args = []

    def factory(self, *_, **__):
        def step(state, *args):
            self.args.append(tuple(a.numpy() for a in args))
            return state, torch.tensor(0.0)

        return step


_INITS = {}


def jit_init(model, *example):
    """model.init(PRNGKey(0), *example), compiled (cached per model and
    shapes)."""
    key = (repr(model), tuple((tuple(e.shape), str(e.dtype)) for e in example))
    if key not in _INITS:
        _INITS[key] = jax.tree_util.tree_map(
            np.asarray, REAL_JIT(model.init)(jax.random.PRNGKey(0), *example))
    return _INITS[key]


def init_state(model, example, optimizer):
    """The demos' init_train_state, through `jit_init`."""
    v = jit_init(model, example)
    return jtn.TrackNetTrainState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                                  opt_state=optimizer.init(v["params"]), step=0)


def fake_state(*_):
    return jtn.TrackNetTrainState(params=None, batch_stats=None, opt_state=None, step=0)


def to_port(variables) -> dict:
    """A Flax variable tree -> the port's state_dict (writable copies)."""
    return state_dict_from_flax(jax.tree_util.tree_map(np.array, dict(variables)))


def variables(state) -> dict:
    return {"params": state.params, "batch_stats": state.batch_stats}


class JitApply:
    """A Flax model whose apply is jitted: the demos' evaluations call
    model.apply eagerly, one dispatch an op."""

    def __init__(self, model):
        self.apply = REAL_JIT(model.apply)


def yolo_loss(model, state, image_hw, pose, images, *gts) -> float:
    """The JAX YOLO step's loss (its loss_fn) at `state` on one batch."""
    centers, strides = anchor_table(*image_hw)
    anc_px, strides_j = jnp.asarray(centers * strides[:, None]), jnp.asarray(strides)
    loss = jyolo.yolo_pose_loss if pose else jyolo.yolo_detection_loss

    def f(v, images, *gts):
        out, _ = model.apply(v, images, train=True, raw=True, mutable=["batch_stats"])
        return loss(out, anc_px, strides_j, *gts)[0]

    return float(REAL_JIT(f)(variables(state), images, *gts))
