"""The port's Flax msgpack codec (core/checkpoint.py, standard library and
numpy, no msgpack package) and its variable trees (models/convert.py::
flax_from_state_dict) against Flax itself, in both directions:

- the reader gives what `flax.serialization.msgpack_restore` gives (keys,
  nesting, dtypes, values) on the JAX package's own trees written by its
  `_engine.save_variables`: TrackNet, InpaintNet, ResNet-50 (one block a
  stage), YOLOv8n detect and pose;
- the writer's bytes are `flax.serialization.to_bytes`'s, byte for byte, on
  the tree `flax_from_state_dict` makes of a port model; JAX's
  `_engine.load_variables` restores them leaf- and dtype-equal to the
  JAX model's own tree shape, and back through `state_dict_from_flax` to
  the port model's weights exactly;
- a hypothesis round trip over the msgpack subset (every int width,
  float64, str / bin lengths across the fix / 8 / 16 / 32 boundaries,
  nested maps and arrays, ndarrays of float32 / float16 / int32 / uint8 /
  bool / bfloat16 with ext payloads across every ext form, numpy scalars,
  complex, and Flax's chunked arrays with its MAX_CHUNK_SIZE made small on
  the oracle side): the writer's bytes equal Flax's and the reader equals
  Flax's; float32 (which Flax never writes) read as msgpack writes it;
- malformed input raises ValueError: an unknown ext code, a reserved byte,
  a truncated buffer, trailing bytes, a dtype numpy does not know (naming
  the leaf); a directory that is no orbax checkpoint raises ValueError
  (orbax directories themselves: tests/test_torch_orbax.py).
"""

import copy
from unittest import mock

import flax.serialization as fser
import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from padel_analytics_tpu.models.resnet import ResNet50Regressor as JaxResNet
from padel_analytics_tpu.models.tracknet import InpaintNet as JaxInpaintNet
from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from padel_analytics_tpu.trackers import _engine
from padel_analytics_tpu_torch.core import checkpoint as ckpt
from padel_analytics_tpu_torch.models import convert
from padel_analytics_tpu_torch.models.layers import lecun_normal_
from padel_analytics_tpu_torch.models.resnet import ResNet50Regressor
from padel_analytics_tpu_torch.models.tracknet import InpaintNet, make_tracknet
from padel_analytics_tpu_torch.models.yolov8 import YOLOv8

#: name -> (JAX model, its example input, the port model of the same
#: architecture).
MODELS = {
    "tracknet": lambda: (jax_make_tracknet(8, "concat")[0], jnp.zeros((1, 32, 64, 27)),
                         make_tracknet(8, "concat")[0]),
    "inpaintnet": lambda: (JaxInpaintNet(), (jnp.zeros((1, 16, 2)), jnp.zeros((1, 16, 1))),
                           InpaintNet()),
    "resnet": lambda: (JaxResNet(stage_sizes=(1, 1, 1, 1)), jnp.zeros((1, 32, 32, 3)),
                       ResNet50Regressor(stage_sizes=(1, 1, 1, 1))),
    "yolo_detect": lambda: (JaxYOLOv8(variant="n", num_classes=1), jnp.zeros((1, 64, 64, 3)),
                            YOLOv8("n", 1)),
    "yolo_pose": lambda: (JaxYOLOv8(variant="n", num_classes=1, num_keypoints=13),
                          jnp.zeros((1, 64, 64, 3)), YOLOv8("n", 1, num_keypoints=13)),
}


def assert_trees_equal(got, want, path="") -> None:
    """Same keys in the same nesting, and each leaf of the same type, dtype
    and value (torch.bfloat16 against ml_dtypes bfloat16 by their bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, got, want)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and want != want:
        assert type(got) is float and got != got, path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def jax_tree(name):
    model, example, _ = MODELS[name]()
    variables = _engine.load_variables(model, example, None)
    return model, example, jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.mark.parametrize("name", list(MODELS))
def test_reader_equals_flax_on_jax_trees(name, tmp_path):
    _, _, variables = jax_tree(name)
    path = tmp_path / f"{name}.msgpack"
    _engine.save_variables(variables, str(path))
    data = path.read_bytes()
    got = ckpt.msgpack_restore(data)
    assert_trees_equal(got, fser.msgpack_restore(data))
    assert_trees_equal(ckpt.load_checkpoint(path), got)
    assert all(v.flags.writeable for v in convert._walk(got) for v in [v[1]])


@pytest.mark.parametrize("name", list(MODELS))
def test_writer_is_flax_to_bytes_and_loads_in_jax(name, tmp_path):
    model, example, init_vars = jax_tree(name)
    port = MODELS[name]()[2]
    lecun_normal_(port, torch.Generator().manual_seed(7))
    with torch.no_grad():  # BN statistics that are not the identity
        for key, value in port.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                value.uniform_(0.5, 1.5)
    tree = convert.flax_from_state_dict(port.state_dict())
    data = ckpt.msgpack_serialize(tree)
    assert data == fser.to_bytes(tree)
    path = tmp_path / f"{name}.msgpack"
    convert.save_flax(path, port)
    assert path.read_bytes() == data

    loaded = jax.tree_util.tree_map(
        np.asarray, dict(_engine.load_variables(model, example, str(path))))
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(init_vars)
    for (kp, a), b in zip(jax.tree_util.tree_leaves_with_path(loaded),
                          jax.tree_util.tree_leaves(init_vars)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, kp
    assert_trees_equal(fser.from_bytes(init_vars, data), loaded)
    back = convert.state_dict_from_flax(loaded)
    for key, value in port.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], value), key


# ------------------------------------------------------------------ hypothesis

_INTS = st.one_of(
    st.integers(-32, 127),
    st.sampled_from([128, 255, 256, 2**16 - 1, 2**16, 2**32 - 1, 2**32, 2**64 - 1,
                     -33, -128, -129, -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63]),
    st.integers(-2**63, 2**64 - 1),
)
_LENGTHS = st.sampled_from([0, 1, 31, 32, 255, 256, 2**16 - 1, 2**16])
_DTYPES = ["float32", "float16", "int32", "uint8", "bool", "bfloat16"]


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    # sizes whose ext payloads take fixext 16, ext 8, ext 16 and ext 32
    n = draw(st.sampled_from([0, 1, 2, 3, 5, 40, 300, 17_000, 70_000]))
    shape = draw(st.sampled_from([(n,), (1, n), (n, 1)])) if n else (0,)
    seed = draw(st.integers(0, 2**32 - 1))
    bits = np.random.default_rng(seed).integers(0, 256, n * 4, dtype=np.uint8)
    if dtype == "bool":
        return (bits[:n] & 1).astype(bool).reshape(shape)
    if dtype == "bfloat16":
        return bits[: n * 2].view(np.uint16).view(ml_dtypes.bfloat16).reshape(shape)
    return bits[: n * np.dtype(dtype).itemsize].view(dtype).reshape(shape)


_SCALARS = st.one_of(
    st.none(), st.booleans(), _INTS, st.floats(allow_nan=True, allow_infinity=True),
    _LENGTHS.map(lambda n: "é" * (n // 2) + "x" * (n % 2)),
    _LENGTHS.map(lambda n: bytes(range(256)) * (n // 256) + bytes(n % 256)),
    st.complex_numbers(allow_nan=False),
    _arrays(),
    # numpy scalars (a bfloat16 one reads back as a 0-dim torch tensor, which
    # writes as an array: test_bfloat16_scalar_reads_as_a_tensor)
    _arrays().filter(lambda a: a.dtype != ml_dtypes.bfloat16)
    .map(lambda a: a.reshape(-1)[0] if a.size else np.float32(0.5)),
)
_TREES = st.recursive(
    _SCALARS,
    lambda children: st.one_of(
        st.lists(children, max_size=20),
        st.dictionaries(st.text(max_size=40), children, max_size=20),
    ),
    max_leaves=40,
)


def _port_form(tree):
    """The tree the port's writer takes: bfloat16 leaves as torch tensors."""
    if isinstance(tree, dict):
        return {k: _port_form(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_form(v) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)) and tree.dtype == ml_dtypes.bfloat16:
        out = torch.from_numpy(np.array(tree).view(np.int16)).view(torch.bfloat16)
        return out if isinstance(tree, np.ndarray) else out.reshape(())
    return tree


@settings(max_examples=80, deadline=None, database=None)
@given(tree=st.dictionaries(st.text(max_size=8), _TREES, max_size=6),
       chunk=st.sampled_from([2**30, 64, 1000]))
def test_round_trip_equals_flax(tree, chunk):
    with mock.patch.object(fser, "MAX_CHUNK_SIZE", chunk), \
            mock.patch.object(ckpt, "MAX_CHUNK_SIZE", chunk):
        want = fser.msgpack_serialize(copy.deepcopy(tree), in_place=True)
        got = ckpt.msgpack_serialize(_port_form(tree))
    assert got == want
    restored = fser.msgpack_restore(want)
    assert_trees_equal(ckpt.msgpack_restore(want), restored)


@settings(max_examples=40, deadline=None, database=None)
@given(tree=st.dictionaries(st.text(max_size=8), st.recursive(
    st.one_of(st.none(), st.booleans(), _INTS, st.floats(width=32),
              _LENGTHS.map(lambda n: "a" * n)),
    lambda c: st.one_of(st.lists(c, max_size=5), st.dictionaries(st.text(max_size=4), c,
                                                                  max_size=5)),
    max_leaves=20), max_size=5))
def test_reader_takes_float32_and_every_form_msgpack_writes(tree):
    data = msgpack.packb(tree, use_single_float=True)
    assert_trees_equal(ckpt.msgpack_restore(data), msgpack.unpackb(data, raw=False))


def test_bfloat16_scalar_reads_as_a_tensor():
    value = np.asarray(1.5, ml_dtypes.bfloat16)[()]
    data = fser.to_bytes({"s": value, "a": np.full((2, 3), 2.25, ml_dtypes.bfloat16)})
    got = ckpt.msgpack_restore(data)
    assert_trees_equal(got, fser.msgpack_restore(data))
    assert got["s"].shape == () and float(got["s"]) == 1.5


def test_chunked_arrays_restore_as_flax_writes_them():
    arr = np.arange(1000, dtype=np.float32).reshape(10, 100)
    with mock.patch.object(fser, "MAX_CHUNK_SIZE", 256):
        data = fser.to_bytes({"a": {"w": arr}, "b": arr[:2]})
    assert b"__msgpack_chunked_array__" in data
    got = ckpt.msgpack_restore(data)
    assert_trees_equal(got, fser.msgpack_restore(data))
    np.testing.assert_array_equal(got["a"]["w"], arr)


# ------------------------------------------------------------------ refusals


@pytest.mark.parametrize("data,match", [
    (b"\x81\xa1a\xd4\x05\x00", "unknown ext type 5 at a"),  # fixext 1, code 5
    (b"\xc7\x02\x07ab", "unknown ext type 7"),  # ext 8, code 7
    (b"\xd6\xff\x00\x00\x00\x00", "unknown ext type -1"),  # msgpack's timestamp
    (b"\xc1", "reserved byte 0xc1"),
    (b"\x92\x01", "truncated"),
    (b"\x01\x02", "1 bytes after"),
    (b"\x81\x01\x02", "map key 1"),
])
def test_malformed_input_raises(data, match):
    with pytest.raises(ValueError, match=match):
        ckpt.msgpack_restore(data)


def test_unknown_dtype_names_the_leaf():
    payload = msgpack.packb(([2], "float8_e9m9", b"\x00\x00"), use_bin_type=True)
    data = msgpack.packb({"params": {"conv": {"kernel": msgpack.ExtType(1, payload)}}})
    with pytest.raises(ValueError, match="params/conv/kernel.*float8_e9m9"):
        ckpt.msgpack_restore(data)
    short = msgpack.packb({"w": msgpack.ExtType(1, msgpack.packb(
        ([3], "float32", b"\x00" * 8), use_bin_type=True))})
    with pytest.raises(ValueError, match="w: 8 bytes"):
        ckpt.msgpack_restore(short)


def test_unserializable_leaves_raise():
    with pytest.raises(TypeError, match="tuple"):
        ckpt.msgpack_serialize({"a": (1, 2)})  # Flax's strict_types refuse it too
    with pytest.raises(TypeError):
        fser.msgpack_serialize({"a": (1, 2)}, in_place=True)


def test_orbax_directories_are_not_ported(tmp_path):
    """Formerly refused (NotImplementedError), orbax directories are now
    read and written (core/orbax.py): a path that is no .msgpack is a
    directory, a directory without _METADATA is refused, and a missing
    .msgpack still raises."""
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        ckpt.load_checkpoint(tmp_path)
    tree = {"params": {"w": np.arange(3, dtype=np.float32)}, "batch_stats": {}}
    ckpt.save_checkpoint(tree, tmp_path / "ckpt")
    got = ckpt.load_checkpoint(tmp_path / "ckpt")
    assert got["batch_stats"] == {} and np.array_equal(got["params"]["w"], tree["params"]["w"])
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path / "missing.msgpack")
