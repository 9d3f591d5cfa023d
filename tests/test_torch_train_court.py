"""The port's ResNet court training (`training/resnet_court.py`) against
the JAX package's on the same seeded inputs: the normalised targets
equal; the masked and unmasked regression losses within 1e-6 (relative)
with their gradients within 1e-5 of the largest; one and three Adam steps
of the ResNet regressor (stage_sizes (1, 1, 1, 1), 6 outputs, 64 x 64,
batch 2, unmasked as the train app runs it) from the same weights on the
same batches as the JAX package's jitted step: losses, gradients,
parameters and running statistics (Flax's ResNet BatchNorms: momentum
0.99) within the bounds of tests/_torch_train.py.

64 x 64, not the JAX package's own 32 x 32: at 32 the last stage is 1 x 1,
so its BatchNorms take the statistics of 2 values (batch 2), and the fp32
step is ill-conditioned whoever computes it (the JAX loss is 4e-4 from a
float64 loss of the same step, the port's 1e-5 to 4e-4 by its thread
count); at 64 they take 8 and both are within 1e-6 of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_helpers import _random_variables
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
from padel_analytics_tpu.models.resnet import ResNet50Regressor as JaxResNet
from padel_analytics_tpu.training import resnet_court as jcourt
from padel_analytics_tpu_torch.models.convert import state_dict_from_flax
from padel_analytics_tpu_torch.models.resnet import ResNet50Regressor
from padel_analytics_tpu_torch.training import resnet_court
from padel_analytics_tpu_torch.training.state import init_train_state

STAGES = (1, 1, 1, 1)
HW = 64


def test_targets_and_losses_equal_jax(rng):
    kp = rng.uniform(0, 600, (4, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(resnet_court.normalize_court_targets(kp, (640, 360)).numpy(),
                                  np.asarray(jcourt.normalize_court_targets(kp, (640, 360))))
    logits = rng.normal(0, 2, (4, 6)).astype(np.float32)
    targets = rng.uniform(0, 1, (4, 6)).astype(np.float32)
    mask = (rng.uniform(0, 1, (4, 3)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want, g_want = jax.value_and_grad(jcourt.court_regression_loss)(
            jnp.asarray(logits), jnp.asarray(targets), None if m is None else jnp.asarray(m))
        lt = torch.from_numpy(logits).requires_grad_(True)
        got = resnet_court.court_regression_loss(
            lt, torch.from_numpy(targets), None if m is None else torch.from_numpy(m))
        got.backward()
        assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
        g_want = np.asarray(g_want)
        assert np.abs(lt.grad.numpy() - g_want).max() <= 1e-5 * np.abs(g_want).max()


@pytest.fixture(scope="module")
def court_run():
    rng = np.random.default_rng(31)
    model = JaxResNet(num_outputs=6, stage_sizes=STAGES)
    variables = _random_variables(rng, model, jnp.zeros((1, HW, HW, 3), jnp.float32))
    batches = [(rng.normal(0, 1, (2, HW, HW, 3)).astype(np.float32),
                rng.uniform(0, 1, (2, 6)).astype(np.float32)) for _ in range(3)]
    opt = jax_optimizer()
    state = jcourt.CourtTrainState(variables["params"], variables["batch_stats"],
                                   opt.init(variables["params"]), 0)
    step = jax.jit(jcourt.make_court_train_step(model, opt))
    return variables, batches, *run_jax_steps(step, state, [tuple(map(jnp.asarray, b))
                                                            for b in batches])


def _port(variables):
    model = ResNet50Regressor(num_outputs=6, stage_sizes=STAGES)
    model.load_state_dict(state_dict_from_flax(variables))
    return init_train_state(model, LR)


def test_court_one_step_equals_jax(court_run):
    variables, batches, losses, grads, _, _ = court_run
    state, loss = resnet_court.make_court_train_step()(
        _port(variables), *(torch.from_numpy(a) for a in batches[0]))
    assert_losses([float(loss)], losses[:1])
    assert_grads(state.model, grads[0])


def test_court_three_steps_equal_jax(court_run):
    variables, batches, losses, _, starts, final = court_run
    state, got = port_steps(_port(variables), resnet_court.make_court_train_step(), batches,
                            starts)
    assert_losses(got, losses)
    assert_params(state.model, final.params)
    assert_stats(state.model, final.params, final.batch_stats)
