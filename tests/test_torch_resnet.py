"""The port's ResNet-50 court regressor (`models/resnet.py`) against the JAX
package's on the same seeded inputs and the same weights carried across
(`state_dict_from_flax`), and the two checkpoint loaders: a torchvision
resnet50 state_dict through the port's `convert_resnet50_state_dict`, and
through the JAX package's converter then the Flax bridge, give the same
state_dict.

fp32 bound: the port folds BN into a per-channel scale and bias (K1's
epilogue), the JAX package applies (x - mean) * scale / sqrt(var + eps) +
bias; both sum the convs in their own order. Measured ~1e-6 of the logits'
largest magnitude at full depth; held to 1e-4 of it. The bf16 path is held
as tests/test_torch_bf16_jax.py holds the other models: its distance from
the JAX bf16 logits at most 2x the JAX bf16 logits' own distance from fp32,
plus 1e-3 of their scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_helpers import _random_variables
from padel_analytics_tpu.models.convert import (
    convert_resnet50_state_dict as jax_convert_resnet50_state_dict,
)
from padel_analytics_tpu.models.resnet import ResNet50Regressor as JaxResNet
from padel_analytics_tpu.models.resnet import imagenet_normalize as jax_imagenet_normalize
from padel_analytics_tpu_torch.models.convert import (
    convert_resnet50_state_dict,
    state_dict_from_flax,
)
from padel_analytics_tpu_torch.models.resnet import (
    IMAGENET_MEAN,
    ResNet50Regressor,
    imagenet_normalize,
)
from padel_analytics_tpu_torch.ops import conv3x3
from padel_analytics_tpu_torch.trackers import KeypointsTracker

REL_TOL = 1e-4


def _pair(rng, stage_sizes, hw, dtype=jnp.float32):
    """A JAX ResNet50Regressor with random variables, and the port's with
    the same weights."""
    model = JaxResNet(stage_sizes=stage_sizes, dtype=dtype)
    variables = _random_variables(rng, model, jnp.zeros((1, hw, hw, 3), jnp.float32))
    port = ResNet50Regressor(stage_sizes=stage_sizes)
    port.load_state_dict(state_dict_from_flax(variables))
    return model, variables, port.eval()


@pytest.mark.parametrize("hw", [32, 64])
@pytest.mark.parametrize("stage_sizes", [(1, 1, 1, 1), (3, 4, 6, 3)], ids=["shallow", "resnet50"])
def test_resnet_fp32_equals_jax(rng, stage_sizes, hw):
    model, variables, port = _pair(rng, stage_sizes, hw)
    x = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    conv3x3.reset_launches()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert conv3x3.launches == 0  # the CPU runs the plain version
    assert got.shape == want.shape == (2, 24) and got.dtype == np.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= REL_TOL * scale


def test_resnet_stride1_convs_take_the_fused_path():
    """The 13 stride-1 3x3 conv2s are K1's (ConvBN.fused); the stem, the 1x1
    convs and the strided conv2s are not."""
    model = ResNet50Regressor()
    fused = [name for name, m in model.named_modules() if getattr(m, "fused", False)]
    assert len(fused) == 13 and all(name.endswith(".conv2") for name in fused)
    assert not any(name.startswith(("layer2_0", "layer3_0", "layer4_0")) for name in fused)
    assert model.layer1_0.down_conv.act == model.layer1_0.conv3.act == "none"


def test_resnet_bf16_within_the_jax_bf16_bound(rng):
    hw = 64
    model32, variables, port = _pair(rng, (1, 1, 1, 1), hw)
    model16 = JaxResNet(stage_sizes=(1, 1, 1, 1), dtype=jnp.bfloat16)
    x = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    ref = np.asarray(model32.apply(variables, jnp.asarray(x)))
    jax16 = np.asarray(model16.apply(variables, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    scale = float(np.abs(ref).max())
    own = float(np.abs(jax16 - ref).max())
    assert float(np.abs(got - jax16).max()) <= 2 * own + 1e-3 * scale


def _torchvision_keys(port_sd):
    """The port's state_dict under torchvision's resnet50 names."""
    out = {}
    for key, value in port_sd.items():
        parts = key.split(".")
        if parts[0].startswith("layer"):
            stage, block = parts[0].split("_")
            parts = [stage, block] + parts[1:]
        if "down_conv" in parts:
            i = parts.index("down_conv")
            parts[i: i + 2] = ["downsample", {"conv": "0", "bn": "1"}[parts[i + 1]]]
        elif parts[-2] == "bn":
            parts[-3:-1] = [parts[-3].replace("conv", "bn")]
        elif parts[-2] == "conv":
            del parts[-2]
        out[".".join(parts)] = value.clone()
    return out


def test_torchvision_and_flax_loaders_equal(rng, tmp_path):
    """A torchvision state_dict loads into the port directly, and through
    the JAX package's converter and the Flax bridge, to the same tensors;
    the tracker loads it from a .pt file too."""
    port = ResNet50Regressor()
    state = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
             if v.is_floating_point() else v for k, v in port.state_dict().items()}
    tv = _torchvision_keys(state)
    assert "layer1.0.downsample.1.running_var" in tv and "layer4.2.bn3.weight" in tv
    assert "fc.weight" in tv and "conv1.weight" in tv and "bn1.running_mean" in tv
    direct = convert_resnet50_state_dict(tv)
    bridged = state_dict_from_flax(jax_convert_resnet50_state_dict(tv))
    assert set(direct) == set(state)
    floats = {k for k, v in state.items() if v.is_floating_point()}
    assert set(bridged) >= floats
    for k in floats:
        assert torch.equal(direct[k], state[k]) and torch.equal(bridged[k], state[k]), k
    torch.save(tv, tmp_path / "court_resnet.pt")
    tracker = KeypointsTracker(str(tmp_path / "court_resnet.pt"), model_type="resnet",
                               device="cpu", compute_dtype=torch.float32)
    loaded = tracker.engine.model.state_dict()
    assert all(torch.equal(loaded[k], state[k]) for k in floats)


def test_imagenet_normalize_equals_jax(rng):
    assert IMAGENET_MEAN == (0.485, 0.465, 0.406)  # the reference's 0.465 (sic)
    x = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    got = imagenet_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_imagenet_normalize(jnp.asarray(x))))


def test_jax_variables_cover_the_port_module(rng):
    """Every parameter and statistic of the port's module comes from the
    JAX tree (no tensor left at its initial value by a missed name)."""
    model = JaxResNet(stage_sizes=(1, 1, 1, 1))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    sd = state_dict_from_flax(variables)
    port = ResNet50Regressor(stage_sizes=(1, 1, 1, 1))
    assert set(sd) == set(port.state_dict())
