"""The port's ConvBN in train mode (`models/layers.py`) against Flax's
`ConvBN(train=True)` of the JAX package (Flax nn.BatchNorm over the batch's
statistics) on the same seeded inputs and weights: the outputs, the
gradients of the input and of every parameter, and the updated running
statistics (Flax's update with the biased batch variance and each model's
momentum: 0.9 TrackNet, 0.97 YOLOv8, 0.99 ResNet-50).

fp32 bounds, each stated beside its assert: the outputs and gradients
within 1e-4 of the largest magnitude of the JAX tensor (two conv
summation orders and two reductions for the mean and variance; measured
below 2e-6), the running statistics within 1e-5 of theirs. The unbiased
update torch's own F.batch_norm makes misses by more than that at these
batch sizes (n / (n - 1) of the variance term), so the test fails if it is
used.

Also: TrackNet with subpixel_up takes the dense upsample + conv in train
mode (its train-mode output is the dense model's, bit for bit), and eval
mode re-folds the BatchNorm after optimizer steps and running-statistic
updates (the folded cache's key changes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu.models.layers import ConvBN as JaxConvBN
from padel_analytics_tpu_torch.models.layers import ConvBN
from padel_analytics_tpu_torch.models.tracknet import TrackNet
from padel_analytics_tpu_torch.models.yolov8 import YoloConv
from padel_analytics_tpu_torch.training.state import adam

REL_TOL = 1e-4
STATS_TOL = 1e-5

# (kernel, stride, act, eps, momentum, port class): TrackNet's, YOLOv8's
# stride-1 and strided convs and 1x1, ResNet-50's stem.
CASES = {
    "tracknet3x3": (3, 1, "relu", 1e-5, 0.9, ConvBN),
    "yolo3x3": (3, 1, "silu", 1e-3, 0.97, YoloConv),
    "yolo3x3s2": (3, 2, "silu", 1e-3, 0.97, YoloConv),
    "yolo1x1": (1, 1, "silu", 1e-3, 0.97, YoloConv),
    "resnet7x7s2": (7, 2, "relu", 1e-5, 0.99, ConvBN),
}
ACTS = {"relu": fnn.relu, "silu": fnn.silu}


def _close(got, want, name, tol=REL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale + 1e-7, f"{name}: max err {err} at scale {scale}"
    return err


def _pair(rng, case, cin=5, cout=8):
    k, s, act, eps, mom, cls = CASES[case]
    jmod = JaxConvBN(cout, (k, k), (s, s), act=ACTS[act], bn_eps=eps, bn_momentum=mom)
    variables = {
        "params": {"conv": {"kernel": (rng.standard_normal((k, k, cin, cout))
                                       / np.sqrt(k * k * cin)).astype(np.float32)},
                   "bn": {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                          "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}},
        "batch_stats": {"bn": {"mean": (rng.standard_normal(cout) * 0.1).astype(np.float32),
                               "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}},
    }
    port = cls(cin, cout, k, s) if cls is YoloConv else cls(cin, cout, k, s, act=act, bn_eps=eps,
                                                           bn_momentum=mom)
    assert port.bn_momentum == mom and port.bn.eps == eps and port.act == act
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(
            variables["params"]["conv"]["kernel"].transpose(3, 2, 0, 1).copy()))
        port.bn.weight.copy_(torch.from_numpy(variables["params"]["bn"]["scale"]))
        port.bn.bias.copy_(torch.from_numpy(variables["params"]["bn"]["bias"]))
        port.bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["bn"]["mean"]))
        port.bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["bn"]["var"]))
    return jmod, variables, port.train()


@pytest.mark.parametrize("case", list(CASES))
def test_convbn_train_matches_flax(rng, case):
    jmod, variables, port = _pair(rng, case)
    x = (rng.standard_normal((2, 9, 10, 5)) * 2 + 0.5).astype(np.float32)
    y_shape = jax.eval_shape(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"])[0],
                             variables, jnp.asarray(x)).shape
    ct = rng.standard_normal(y_shape).astype(np.float32)

    def loss(params, x):
        y, upd = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (_, (y_j, stats_j)), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = port(xt)
    (y_t * torch.from_numpy(ct)).sum().backward()

    _close(y_t.detach(), y_j, "output")  # 1e-4 of the largest |output|
    _close(xt.grad, g_x, "d input")  # 1e-4 of the largest |gradient|
    _close(port.conv.weight.grad.permute(2, 3, 1, 0), g_params["conv"]["kernel"], "d kernel")
    _close(port.bn.weight.grad, g_params["bn"]["scale"], "d scale")
    _close(port.bn.bias.grad, g_params["bn"]["bias"], "d bias")
    # Flax's running update: within 1e-5 of the statistics' magnitude.
    _close(port.bn.running_mean, stats_j["bn"]["mean"], "running mean", STATS_TOL)
    _close(port.bn.running_var, stats_j["bn"]["var"], "running var", STATS_TOL)

    # torch's own update (unbiased variance, its momentum in its convention)
    # misses Flax's by more than the bound: the test tells them apart.
    torch_bn = torch.nn.BatchNorm2d(8, eps=port.bn.eps, momentum=1.0 - port.bn_momentum)
    torch_bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["bn"]["mean"]))
    torch_bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["bn"]["var"]))
    with torch.no_grad():
        torch_bn.train()(F.conv2d(xt.permute(0, 3, 1, 2), port.conv.weight,
                                  stride=port.conv.stride, padding=port.conv.padding))
    want_var = np.asarray(stats_j["bn"]["var"])
    miss = float(np.abs(torch_bn.running_var.numpy() - want_var).max())
    assert miss > 10 * STATS_TOL * float(np.abs(want_var).max()), miss


def test_eval_refolds_after_training(rng):
    """After Adam steps and running-statistic updates, eval mode folds the
    new parameters: the folded cache's key changes and the output equals a
    fresh module's with the same state."""
    _, _, port = _pair(rng, "tracknet3x3")
    x = torch.from_numpy(rng.standard_normal((2, 9, 10, 5)).astype(np.float32))
    with torch.no_grad():
        port.eval()(x)
    key0 = port._cache[0]
    opt = adam(port, 1e-2)
    for _ in range(2):
        opt.zero_grad()
        port.train()(x).square().mean().backward()
        opt.step()
    with torch.no_grad():
        got = port.eval()(x)
    assert port._cache[0] != key0
    fresh = ConvBN(5, 8)
    fresh.load_state_dict(port.state_dict())
    with torch.no_grad():
        want = fresh.eval()(x)
    assert torch.equal(got, want)


def test_subpixel_tracknet_trains_dense(rng):
    """The subpixel rewrite is eval-only: in train mode TrackNet(subpixel_up)
    runs the dense upsample + conv of the same parameters, as the JAX
    package's; its output, gradients and running statistics are the dense
    model's exactly."""
    torch.manual_seed(0)
    dense = TrackNet(9, 2, subpixel_up=False)
    sub = TrackNet(9, 2, subpixel_up=True)
    sub.load_state_dict(dense.state_dict())
    x = torch.from_numpy(rng.uniform(0, 1, (2, 16, 32, 9)).astype(np.float32))
    outs = []
    for m in (dense, sub):
        y = m.train()(x)
        y.sum().backward()
        outs.append((y.detach(), {k: p.grad for k, p in m.named_parameters()},
                     {k: b for k, b in m.named_buffers()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for d in (1, 2):
        assert outs[0][d].keys() == outs[1][d].keys()
        for k in outs[0][d]:
            assert torch.equal(outs[0][d][k], outs[1][d][k]), k
