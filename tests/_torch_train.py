"""Shared pieces of the port's training parity tests
(tests/test_torch_train_*.py): the JAX package's own train steps, run once
per test module with a gradient recorder chained before its Adam, and the
comparisons of a port model's losses, gradients, parameters and running
statistics with them.

`record_grads` is an identity optax transformation whose state is the
latest gradient: `optax.chain(record_grads(), optax.adam(lr))` updates the
parameters exactly as `optax.adam(lr)` does, and the JAX step's opt_state
then carries the gradient it took.

Bounds (each comparison states its own):
- loss: within LOSS_TOL of the JAX loss (relative) from the same weights;
- gradients: the whole model's within GRAD_L2_TOL of the JAX gradient
  (relative L2 norm over every parameter), each tensor's within
  GRAD_TENSOR_TOL (relative L2). These are loose because the step itself
  is ill-conditioned in fp32, whoever computes it (Flax's fast variance,
  E[x^2] - E[x]^2, makes about half of the error: a two-pass variance
  halves it); on TrackNet at 32 x 64
  the JAX package's own fp32 gradient is 0.65% (relative L2) from a float64
  gradient of the same step, and up to 6% in a tensor's largest element;
  the port's is 0.40% from it. A wrong formula (the BatchNorm's gradient
  through its statistics, a loss term) misses by the gradient's own size;
  the loss, within LOSS_TOL, catches a wrong forward;
- three Adam steps: the port's steps each start from the parameters the
  JAX step started from, its optimizer's moments and running statistics
  carrying over as in training. Free-running, the two diverge within a
  step: Adam's first step moves every element by about lr * sign(g), so
  the elements whose gradient is rounding noise (0.27% of TrackNet's) step
  apart, and the step-2 gradients then differ by 33% (relative L2, at lr
  1e-3), although from the same parameters they agree within 1.8%. The
  losses within LOSS_TOL; after the steps at most PARAM_FRAC of the
  parameters more than PARAM_TOL_LR * lr from the JAX parameters (measured
  0.2% on TrackNet), none more than PARAM_MAX_LR * lr (measured 1.34);
- running statistics: within STATS_TOL of the largest magnitude of the JAX
  statistic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from padel_analytics_tpu_torch.models.convert import state_dict_from_flax

LOSS_TOL = 1e-5
GRAD_L2_TOL = 2e-2
GRAD_TENSOR_TOL = 5e-2
PARAM_TOL_LR = 0.05
PARAM_FRAC = 1e-2
PARAM_MAX_LR = 3.0
STATS_TOL = 1e-4
LR = 1e-3


def record_grads() -> optax.GradientTransformation:
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return updates, updates

    return optax.GradientTransformation(init, update)


def jax_optimizer(lr: float = LR) -> optax.GradientTransformation:
    return optax.chain(record_grads(), optax.adam(lr))


def run_jax_steps(step, state, batches):
    """Run the jitted JAX `step` over `batches` (tuples of its arguments);
    returns (losses, each step's gradients, the parameters each step
    started from (Flax trees), the final state)."""
    losses, grads, starts = [], [], []
    for batch in batches:
        starts.append(jax.tree_util.tree_map(np.asarray, state.params))
        state, loss = step(state, *batch)
        losses.append(float(loss))
        grads.append(jax.tree_util.tree_map(np.asarray, state.opt_state[0]))
    return losses, grads, starts, state


def load_params_(model, jax_params) -> None:
    """Copy a Flax params tree into `model`'s parameters in place (the
    optimizer's moments, keyed by the parameter objects, carry on)."""
    sd = torch_names(jax_params)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(sd[k])


def torch_names(params, batch_stats=None) -> dict:
    """A Flax params (and batch_stats) tree -> {port name: tensor}."""
    variables = {"params": jax.tree_util.tree_map(np.asarray, params)}
    if batch_stats is not None:
        variables["batch_stats"] = jax.tree_util.tree_map(np.asarray, batch_stats)
    sd = state_dict_from_flax(variables)
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def assert_losses(got, want):
    """Each loss within LOSS_TOL of the JAX step's (relative)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= LOSS_TOL * abs(w), f"loss {i}: {g} vs {w}"


def assert_grads(model, jax_grads) -> tuple[float, float]:
    """The gradients against the JAX step's: the whole model's within
    GRAD_L2_TOL (relative L2 over every parameter), each tensor's within
    GRAD_TENSOR_TOL (relative L2). Returns (the whole model's error, the
    worst tensor's)."""
    want = torch_names(jax_grads)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    worst, num, den = 0.0, 0.0, 0.0
    for k, w in want.items():
        d2, w2 = float((got[k] - w).norm()) ** 2, float(w.norm()) ** 2
        num, den = num + d2, den + w2
        rel = (d2 / max(w2, 1e-60)) ** 0.5
        assert rel <= GRAD_TENSOR_TOL, f"grad {k}: relative L2 error {rel}"
        worst = max(worst, rel)
    total = (num / den) ** 0.5
    assert total <= GRAD_L2_TOL, f"gradient: relative L2 error {total}"
    return total, worst


def assert_params(model, jax_params, lr: float = LR) -> tuple[float, float]:
    """The parameters after the steps against the JAX step's: at most
    PARAM_FRAC of the elements more than PARAM_TOL_LR * lr away, none more
    than PARAM_MAX_LR * lr. Returns (that fraction, the largest error in
    units of lr)."""
    want = torch_names(jax_params)
    sd = dict(model.named_parameters())
    assert set(sd) == set(want)
    d = torch.cat([((sd[k].detach() - w).abs() / lr).reshape(-1) for k, w in want.items()])
    frac, worst = float((d > PARAM_TOL_LR).float().mean()), float(d.max())
    assert frac <= PARAM_FRAC, f"{frac} of the parameters beyond {PARAM_TOL_LR} lr"
    assert worst <= PARAM_MAX_LR, f"a parameter {worst} lr away"
    return frac, worst


def port_steps(state, step, batches, starts):
    """The port's steps over `batches` (numpy tuples), each from the
    parameters the JAX step started from (`load_params_`); the optimizer's
    moments and the running statistics carry over. Returns (state, losses)."""
    losses = []
    for batch, start in zip(batches, starts):
        load_params_(state.model, start)
        state, loss = step(state, *(torch.from_numpy(np.asarray(a)) for a in batch))
        losses.append(float(loss))
    return state, losses


def assert_stats(model, jax_params, jax_stats):
    """Every running mean and variance within STATS_TOL of the JAX
    statistic's largest magnitude."""
    want = {k: v for k, v in torch_names(jax_params, jax_stats).items() if ".running_" in k}
    bufs = dict(model.named_buffers())
    assert want and set(want) <= set(bufs)
    for k, w in want.items():
        assert _max_rel(bufs[k], w) <= STATS_TOL, k
