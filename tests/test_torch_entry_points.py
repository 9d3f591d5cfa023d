"""The JAX package's call forms of the port's entry points, each against the
JAX package on the same seeded numpy inputs (integer and tree results
equal; any tolerance stated where it is used):

- `core.checkpoint.load_checkpoint(target, path)`: the trees written by
  either package, as Flax ``.msgpack`` and as orbax directories (the JAX
  package's OCDBT, the port's plain layout, and the committed JAX-written
  fixture), restored into targets whose dtypes differ from the file's: the
  JAX result leaf for leaf, dtype and type included; every malformed target
  raises on both sides, and the ones Flax accepts (keys the file has beyond
  the target's, a wrong shape) are accepted on both;
- `DeviceConfig`, `PipelineConfig.device` and `BallTrackerConfig.sigma`
  (kept as `BallTracker.SIGMA`): the JAX package's `to_dict()` of the
  default config and of `examples/config_example.py`, once its
  ``use_pallas`` keys are dropped;
- the ``ops``, ``models`` and ``utils`` re-exports: the JAX ``__all__``
  names, and a call through each package's names;
- `window_in_dim`, `convert_state_dict`, `yolo_name_map`,
  `convert_yolov8_state_dict` and `np_isfinite`; `ResizePlan.src_hw`,
  `ResizePlan.apply(dtype=)` and `DataAnalytics.into_dataframe`.
"""

import runpy
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pandas as pd
import pytest
import torch

import padel_analytics_tpu.models as jax_models
import padel_analytics_tpu.ops as jax_ops
import padel_analytics_tpu.utils as jax_utils
import padel_analytics_tpu_torch.models as port_models
import padel_analytics_tpu_torch.ops as port_ops
import padel_analytics_tpu_torch.utils as port_utils
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_orbax_cases import FIXTURE
from _torch_orbax_fixture import seeded_tree
from padel_analytics_tpu import config as jax_config
from padel_analytics_tpu.analytics.data_analytics import DataAnalytics as JaxDataAnalytics
from padel_analytics_tpu.apps.validate_weights import np_isfinite as jax_np_isfinite
from padel_analytics_tpu.core import checkpoint as jax_checkpoint
from padel_analytics_tpu.models import convert as jax_convert
from padel_analytics_tpu.ops.resize import resize_plan as jax_resize_plan
from padel_analytics_tpu.trackers import BallTracker as JaxBallTracker
from padel_analytics_tpu.trackers._ballwindow import window_in_dim as jax_window_in_dim
from padel_analytics_tpu_torch import config
from padel_analytics_tpu_torch.analytics.data_analytics import DataAnalytics
from padel_analytics_tpu_torch.apps.validate_weights import np_isfinite
from padel_analytics_tpu_torch.core import checkpoint
from padel_analytics_tpu_torch.models import convert
from padel_analytics_tpu_torch.models.tracknet import make_tracknet
from padel_analytics_tpu_torch.ops.resize import resize_plan
from padel_analytics_tpu_torch.trackers import BallTracker
from padel_analytics_tpu_torch.trackers._ballwindow import window_in_dim
from test_torch_analytics import _feed
from test_yolo_convert_twin import build_torch_yolov8n

EXAMPLE = Path(__file__).parents[1] / "examples" / "config_example.py"


# ------------------------------------------------------ load_checkpoint(target, path)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _tree(rng):
    return {
        "params": {"conv": {"kernel": rng.normal(0, 0.02, (3, 3, 4, 8)).astype(np.float32),
                            "bias": rng.normal(0, 0.02, 8).astype(np.float32)},
                   "bf": _bf16(rng.normal(size=(5, 7)).astype(np.float32))},
        "step": np.int32(7),
        "f64": rng.normal(size=(4,)).astype(np.float64),
        "lst": [np.arange(3, dtype=np.int64), np.ones((2, 2), np.float32)],
    }


def _target(rng):
    """The tree's structure with other dtypes: float32 -> float64 and
    bfloat16, bfloat16 -> float32, int32 -> int64, a tuple for the list."""
    t = _tree(rng)
    t["params"]["conv"]["kernel"] = np.zeros((3, 3, 4, 8), np.float64)
    t["params"]["conv"]["bias"] = _bf16(np.zeros(8))
    t["params"]["bf"] = np.zeros((5, 7), np.float32)
    t["step"] = np.int64(0)
    t["lst"] = (np.zeros(3, np.int32), np.zeros((2, 2), np.float32))
    return t


def _same(got, want, where="") -> None:
    """Nesting and container types equal; leaves of one type, dtype, shape
    and bits (the port's bfloat16 is a torch tensor, JAX's ml_dtypes)."""
    if isinstance(want, (dict, list, tuple)):
        assert type(got) is type(want), (where, type(got), type(want))
        keys = list(want) if isinstance(want, dict) else range(len(want))
        assert (list(got) if isinstance(got, dict) else range(len(got))) == keys, where
        for k in keys:
            _same(got[k], want[k], f"{where}/{k}")
    elif np.asarray(want).dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == np.shape(want), where
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=where)
    else:
        assert type(got) is type(want) and got.dtype == want.dtype, (where, got, want)
        assert got.shape == want.shape, where
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), where


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{label: path} of the tree written by each package in each format."""
    root = tmp_path_factory.mktemp("ckpt")
    tree = _tree(np.random.default_rng(16))
    paths = {"jax.msgpack": root / "jax.msgpack", "port.msgpack": root / "port.msgpack",
             "jax_ocdbt": root / "jax_ocdbt", "port_plain": root / "port_plain"}
    jax_checkpoint.save_checkpoint(tree, str(paths["jax.msgpack"]))
    jax_checkpoint.save_checkpoint(tree, str(paths["jax_ocdbt"]))
    # the port holds bfloat16 as a torch tensor (numpy has none)
    tree["params"]["bf"] = torch.from_numpy(tree["params"]["bf"].view(np.int16).copy()).view(
        torch.bfloat16)
    checkpoint.save_checkpoint(tree, paths["port.msgpack"])
    checkpoint.save_checkpoint(tree, paths["port_plain"])
    return paths


@pytest.mark.parametrize("label", ["jax.msgpack", "port.msgpack", "jax_ocdbt", "port_plain"])
def test_load_checkpoint_into_a_target_equals_jax(written, label):
    target = _target(np.random.default_rng(1))
    path = str(written[label])
    want = jax_checkpoint.load_checkpoint(target, path)
    got = checkpoint.load_checkpoint(target, path)
    _same(got, want)
    # Flax keeps the file's dtypes, orbax casts to the target's.
    assert got["params"]["conv"]["kernel"].dtype == (
        np.float32 if label.endswith("msgpack") else np.float64)
    # A target of None is no target.
    untargeted = checkpoint.load_checkpoint(None, path)
    assert str(untargeted) == str(checkpoint.load_checkpoint(path))


def test_load_checkpoint_into_a_target_reads_the_jax_fixture():
    target = seeded_tree()
    target["step"] = np.float32(0)
    _same(checkpoint.load_checkpoint(target, str(FIXTURE)),
          jax_checkpoint.load_checkpoint(target, str(FIXTURE)))


def _malformed(kind: str):
    t = _tree(np.random.default_rng(2))
    if kind == "missing key":  # the target has a key the file lacks
        t["params"]["extra"] = np.zeros(2, np.float32)
    elif kind == "extra key":  # the file has a key the target lacks
        del t["f64"]
    elif kind == "short list":
        t["lst"] = t["lst"][:1]
    elif kind == "dict for a leaf":
        t["step"] = {"a": np.zeros(1)}
    elif kind == "wrong shape":
        t["params"]["conv"]["kernel"] = np.zeros((2, 2), np.float32)
    return t


@pytest.mark.parametrize("label", ["port.msgpack", "port_plain"])
@pytest.mark.parametrize("kind", ["missing key", "extra key", "short list", "dict for a leaf",
                                  "wrong shape"])
def test_malformed_target_raises_where_jax_raises(written, label, kind):
    target, path = _malformed(kind), str(written[label])
    try:
        want = jax_checkpoint.load_checkpoint(target, path)
    except Exception:  # noqa: BLE001  (Flax raises ValueError or AttributeError)
        with pytest.raises(ValueError):
            checkpoint.load_checkpoint(target, path)
        return
    assert (label, kind) in {("port.msgpack", "extra key"), ("port.msgpack", "wrong shape"),
                             ("port_plain", "wrong shape")}
    _same(checkpoint.load_checkpoint(target, path), want)


# ---------------------------------------------------------------- the configs


def _without_pallas(d):
    if isinstance(d, dict):
        return {k: _without_pallas(v) for k, v in d.items() if k != "use_pallas"}
    return d


def test_pipeline_config_dict_equals_jax():
    """DeviceConfig's fields and defaults, `device` on PipelineConfig and the
    ball's sigma: the JAX package's dict without its use_pallas keys, for the
    defaults and for the example config module."""
    assert config.PipelineConfig().to_dict() == _without_pallas(
        jax_config.PipelineConfig().to_dict())
    flat = {k: v for k, v in runpy.run_path(str(EXAMPLE)).items() if k.isupper()}
    got = config.PipelineConfig.from_flat(flat).to_dict()
    assert got == _without_pallas(jax_config.PipelineConfig.from_flat(flat).to_dict())
    assert got["device"] == {"data_parallel": -1, "model_parallel": 1,
                             "compute_dtype": "bfloat16", "frames_per_chunk": 64}
    device = config.DeviceConfig(data_parallel=2, model_parallel=2, frames_per_chunk=16)
    assert config.PipelineConfig(device=device).device is device


def test_ball_sigma_is_kept_as_the_jax_tracker_keeps_it():
    port = BallTracker(None, device="cpu", config=config.BallTrackerConfig(
        height=16, width=32, sigma=3.5))
    want = JaxBallTracker(None, compute_dtype=jnp.float32, config=jax_config.BallTrackerConfig(
        height=16, width=32, sigma=3.5))
    assert port.SIGMA == want.SIGMA == 3.5
    assert BallTracker.SIGMA == JaxBallTracker.SIGMA == config.BallTrackerConfig().sigma == 2.5


# ------------------------------------------------------------ the re-exports


@pytest.mark.parametrize("jax_pkg,port_pkg", [(jax_ops, port_ops), (jax_models, port_models),
                                              (jax_utils, port_utils)],
                         ids=["ops", "models", "utils"])
def test_subpackages_export_the_jax_names(jax_pkg, port_pkg):
    """Every JAX ``__all__`` name but the TPU kernel's own
    (decode_heatmaps_pallas: the port's decode_heatmaps launches K2), each
    the object of the port's submodule."""
    want = set(jax_pkg.__all__) - {"decode_heatmaps_pallas"}
    assert want <= set(port_pkg.__all__)
    for name in want:
        obj = getattr(port_pkg, name)
        assert getattr(obj, "__module__", port_pkg.__name__).startswith(port_pkg.__name__), name


def test_calls_through_the_reexports_equal_jax(rng):
    heat = (rng.uniform(0, 1, (3, 24, 40)) > 0.93).astype(np.float32)
    got = port_ops.decode_heatmaps(torch.from_numpy(heat))
    want = jax_ops.decode_heatmaps(jnp.asarray(heat))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert port_models.make_tracknet(4, "subtract")[1] == jax_models.make_tracknet(
        4, "subtract")[1] == 4
    assert port_models.YOLOV8_VARIANTS == jax_models.YOLOV8_VARIANTS
    assert port_utils.convert_pixel_distance_to_meters(37, 10.0, 120) == \
        jax_utils.convert_pixel_distance_to_meters(37, 10.0, 120)
    assert port_utils.convert_meters_to_pixel_distance(2.5, 10.0, 120) == \
        jax_utils.convert_meters_to_pixel_distance(2.5, 10.0, 120)


# ------------------------------------------------------------ the smaller names


@pytest.mark.parametrize("bg_mode", ["", "subtract", "subtract_concat", "concat", "other"])
@pytest.mark.parametrize("seq_len", [1, 3, 8])
def test_window_in_dim_equals_jax(bg_mode, seq_len):
    assert window_in_dim(bg_mode, seq_len) == jax_window_in_dim(bg_mode, seq_len)
    model, in_dim = make_tracknet(seq_len, bg_mode)
    assert in_dim == window_in_dim(bg_mode, seq_len) == model.state_dict()[
        "down_block_1.conv_1.conv.weight"].shape[1]


def _same_numpy_tree(got, want, where=""):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _same_numpy_tree(got[k], want[k], f"{where}/{k}")
    else:
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("head_index", [22, 23])
def test_yolo_name_map_equals_jax(head_index):
    assert convert.yolo_name_map(head_index) == jax_convert.yolo_name_map(head_index)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
def test_convert_yolov8_state_dict_equals_jax(dtype):
    """An ultralytics-named YOLOv8n-pose state_dict (seeded), the JAX
    conversion's tree: keys in its order, leaves in the state_dict's dtype."""
    sd = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in build_torch_yolov8n(nc=1, nk=13, seed=3).state_dict().items()}
    _same_numpy_tree(convert.convert_yolov8_state_dict(sd),
                     jax_convert.convert_yolov8_state_dict(sd))
    _same_numpy_tree(convert.convert_yolov8_state_dict(sd, head_index=22),
                     jax_convert.convert_yolov8_state_dict(sd, head_index=22))


def test_convert_state_dict_equals_jax():
    """A Conv2d, Conv1d, Linear and BatchNorm under prefixes the name map
    rewrites (the longest first), and one it leaves."""
    torch.manual_seed(4)
    net = torch.nn.ModuleDict({
        "stem": torch.nn.Conv2d(3, 4, 3), "seq": torch.nn.Conv1d(4, 2, 3),
        "fc": torch.nn.Linear(4, 5), "bn": torch.nn.BatchNorm2d(4),
        "block": torch.nn.ModuleDict({"conv": torch.nn.Conv2d(4, 4, 1, bias=False)})})
    sd = net.state_dict()
    name_map = {"stem": ("backbone", "c0"), "block": ("b",), "block.conv": ("b", "k")}
    _same_numpy_tree(convert.convert_state_dict(sd, name_map),
                     jax_convert.convert_state_dict(sd, name_map))
    _same_numpy_tree(convert.convert_state_dict(sd), jax_convert.convert_state_dict(sd))


@pytest.mark.parametrize("x", [0.0, 2.5, float("inf"), float("-inf"), float("nan"),
                               np.float32(3)])
def test_np_isfinite_equals_jax(x):
    assert np_isfinite(x) is jax_np_isfinite(x)


def test_resize_plan_src_hw_and_dtype_equal_jax(rng):
    img = rng.integers(0, 256, (2, 20, 30, 3)).astype(np.uint8)
    plan, jplan = resize_plan((20, 30), (12, 16)), jax_resize_plan((20, 30), (12, 16))
    assert plan.src_hw == jplan.src_hw == (20, 30)
    got = plan.apply(torch.from_numpy(img), dtype=torch.float64)
    assert got.dtype == torch.float64
    # fp32 on the JAX side: the two differ by its rounding (< 1e-3 of 255).
    np.testing.assert_allclose(got.numpy(), np.asarray(jplan.apply(jnp.asarray(img))), atol=1e-3)


def test_into_dataframe_equals_jax(rng):
    port, jax_da = DataAnalytics(), JaxDataAnalytics()
    _feed([port, jax_da], rng, 40, never=(3,))
    pd.testing.assert_frame_equal(port.into_dataframe(25.0), jax_da.into_dataframe(25.0))
