"""The port's YOLOv8-pose train step (`training/yolo.py`, pose=True)
against the JAX package's: one and three Adam steps of YOLOv8n-pose (3
keypoints) at 64 x 64 (batch 2, 4 gt slots) from the same weights on the
same batches as the JAX package's jitted step; losses, gradients,
parameters and running statistics within the bounds of
tests/_torch_train.py. (The detection step and the losses themselves are
in tests/test_torch_train_yolo.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_helpers import random_jax_yolov8
from _torch_train import (
    LR,
    assert_grads,
    assert_losses,
    assert_params,
    assert_stats,
    jax_optimizer,
    port_steps,
    run_jax_steps,
)
from padel_analytics_tpu.training import yolo as jyolo
from padel_analytics_tpu_torch.models.convert import state_dict_from_flax
from padel_analytics_tpu_torch.models.yolov8 import YOLOv8
from padel_analytics_tpu_torch.training import yolo
from padel_analytics_tpu_torch.training.state import init_train_state
from test_torch_train_yolo import HW, _gts

NK = 3


@pytest.fixture(scope="module")
def pose_run():
    rng = np.random.default_rng(22)
    model, variables = random_jax_yolov8(rng, "n", 1, NK, HW)
    batches = []
    for _ in range(3):
        images = rng.uniform(0, 1, (2, *HW, 3)).astype(np.float32)
        labels, boxes, mask, kpts = _gts(rng, 2, 4, nk=NK)
        batches.append((images, np.zeros_like(labels), boxes, kpts, mask))
    opt = jax_optimizer()
    state = jyolo.YoloTrainState(variables["params"], variables["batch_stats"],
                                 opt.init(variables["params"]), 0)
    step = jax.jit(jyolo.make_yolo_train_step(model, opt, HW, pose=True))
    return variables, batches, *run_jax_steps(step, state, [tuple(map(jnp.asarray, b))
                                                            for b in batches])


def _port(variables):
    model = YOLOv8("n", 1, NK)
    model.load_state_dict(state_dict_from_flax(variables))
    return init_train_state(model, LR)


def test_yolo_pose_one_step_equals_jax(pose_run):
    variables, batches, losses, grads, _, _ = pose_run
    state, loss = yolo.make_yolo_train_step(pose=True)(
        _port(variables), *(torch.from_numpy(a) for a in batches[0]))
    assert_losses([float(loss)], losses[:1])
    assert_grads(state.model, grads[0])


def test_yolo_pose_three_steps_equal_jax(pose_run):
    variables, batches, losses, _, starts, final = pose_run
    state, got = port_steps(_port(variables), yolo.make_yolo_train_step(pose=True), batches,
                            starts)
    assert_losses(got, losses)
    assert_params(state.model, final.params)
    assert_stats(state.model, final.params, final.batch_stats)
