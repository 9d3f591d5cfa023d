"""The port's orbax checkpoint directories (core/orbax.py, core/zarr.py,
core/ocdbt.py) and its hand-written zstd decoder (csrc/zstd_decode.c through
core/zstd.py, built here by the host C compiler), against the installed
zstandard, tensorstore and orbax and the JAX package's own reader:

- (a) the decoder equals zstandard byte for byte at levels 1, 3 and 19 and
  with long-distance matching, on seeded random bytes, N(0, 0.02) float32,
  runs of one byte, text, an empty input and inputs chosen to reach raw and
  RLE literals of every header size, repeat offsets and block sequence
  counts over 0x7F00, each with and without a content checksum, streamed
  (no content size) too; hand-made frames reach raw and RLE blocks, an
  8-byte content size and skippable frames; CRC-32C and XXH64 against their
  published check values;
- (b) truncated, bit-flipped and bad-magic frames, a bad CRC-32C in an OCDBT
  node and a missing compiler each raise, naming the file (or the compiler);
- (c) every leaf of a directory the JAX package's `save_checkpoint` writes
  (OCDBT, zstd zarr v2; a float32 leaf in a data file, bfloat16, a 0-d
  int32, float64, bool, uint8 and a list) reads bit-equal, and so does
  orbax's plain layout (use_ocdbt=False); zarr arrays of several chunks
  (edge chunks, both separators, missing chunks as the fill value, no
  compressor) written by tensorstore read equal;
- (d) tensorstore OCDBT stores whose B+tree has height > 0, and one with
  numbered manifests, read key for key;
- (e) a port-written directory reads bit-equal through the JAX package's
  `load_checkpoint(target, dir)` and `_engine.load_variables`; a second
  save to the same path raises ValueError;
- (g) a zarr3 checkpoint raises NotImplementedError;
- the committed JAX-written fixture (tests/data_torch/orbax_jax/) equals its
  digest file through the JAX package's reader and through the port's.

Also the train apps' random start (apps/_train.py::init_weights): Flax's
truncated LeCun normal, as the JAX apps start, for each app's model.
(Every loader and app given a directory: tests/test_torch_orbax_apps.py.)
"""

import io
import json
import math
import shutil
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from _torch_orbax_cases import DIGESTS, FIXTURE, digest, leaves
from _torch_orbax_fixture import seeded_tree
from padel_analytics_tpu.core import checkpoint as jax_checkpoint
from padel_analytics_tpu.models.tracknet import InpaintNet as JaxInpaintNet
from padel_analytics_tpu.trackers import _engine
from padel_analytics_tpu_torch import _build
from padel_analytics_tpu_torch.apps._train import init_weights
from padel_analytics_tpu_torch.core import checkpoint as ckpt
from padel_analytics_tpu_torch.core import zarr, zstd
from padel_analytics_tpu_torch.core.ocdbt import OcdbtReader
from padel_analytics_tpu_torch.models.convert import flax_from_state_dict
from padel_analytics_tpu_torch.models.layers import _TRUNC2_STD, truncated_lecun_normal_
from padel_analytics_tpu_torch.models.resnet import ResNet50Regressor
from padel_analytics_tpu_torch.models.tracknet import InpaintNet, make_tracknet
from padel_analytics_tpu_torch.models.yolov8 import YOLOv8


# ------------------------------------------------------------------ inputs


def _inputs():
    rng = np.random.default_rng(8878)
    r = rng.integers(0, 256, 200_000, dtype=np.uint8)
    every4 = r.copy()
    every4[::4] = 0x5A  # literals all 0x5A (RLE), 3-byte matches at a repeat offset
    words = rng.integers(0, 256, (512, 3), dtype=np.uint8)
    vocab = ["the", "ball", "court", "player", "padel", "net", "serve", "volley", "lob", "smash"]
    return {
        "random": r[:150_000].tobytes(),
        "normal_f32": rng.normal(0, 0.02, 60_000).astype(np.float32).tobytes(),
        "runs": b"a" * 100_000 + b"b" * 50_000 + b"c" * 7,
        "text": " ".join(rng.choice(vocab, 40_000)).encode(),
        "empty": b"",
        "raw_literals": (r[:30_000].tobytes() + r[:20_000].tobytes() + r[30_000:60_000].tobytes()
                         + r[5000:9000].tobytes()),
        "rle_literals": r.tobytes() + every4.tobytes(),
        "many_sequences": words[rng.integers(0, 512, 150_000)].tobytes(),
    }


INPUTS = _inputs()
#: zstd levels; "ldm": level 19 with long-distance matching, a 128 MiB window.
LEVELS = {"1": {}, "3": {}, "19": {}, "ldm": {"enable_ldm": True, "window_log": 27}}


def _compress(data, level, checksum):
    params = zstandard.ZstdCompressionParameters.from_level(
        19 if level == "ldm" else int(level), write_checksum=int(checksum), **LEVELS[level])
    return zstandard.ZstdCompressor(compression_params=params).compress(data)


# ------------------------------------------------------------- (a) decoder


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", list(LEVELS))
@pytest.mark.parametrize("name", list(INPUTS))
def test_decoder_equals_zstandard(name, level, checksum):
    data = INPUTS[name]
    frame = _compress(data, level, checksum)
    assert zstd.content_size(frame) == len(data)
    assert zstd.decompress(frame, name) == data
    out = np.empty(len(data), np.uint8)
    zstd.decompress_into(frame, out, name)
    assert out.tobytes() == data


@pytest.mark.parametrize("name", ["text", "normal_f32", "empty"])
def test_decoder_streamed_frames(name):
    """Frames with no content size (a streaming writer), several in a row."""
    data = INPUTS[name]
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=3, write_checksum=True).stream_writer(
            buf, closefd=False) as w:
        w.write(data)
    frame = buf.getvalue()
    assert zstd.content_size(frame) == (-1 if data else 0)  # an empty stream states its 0
    assert zstd.decompress(frame + frame, name) == data + data


def _frame(fhd: int, extra: bytes, blocks: bytes, checksum: bytes = b"") -> bytes:
    return struct.pack("<IB", 0xFD2FB528, fhd) + extra + blocks + checksum


def _block(last: bool, kind: int, size: int) -> bytes:
    return (int(last) | kind << 1 | size << 3).to_bytes(3, "little")


def test_decoder_hand_made_frames():
    """Raw and RLE blocks, an 8-byte content size, a window descriptor,
    skippable frames before and between frames, and the checksum's
    XXH64."""
    body = bytes(range(200))
    # single segment, 8-byte content size (FCS flag 3), content checksum
    ck = (zstd.xxh64(body + b"z" * 1000) & 0xFFFFFFFF).to_bytes(4, "little")
    f1 = _frame(0xE4, struct.pack("<Q", 1200),
                _block(False, 0, 200) + body + _block(True, 1, 1000) + b"z", ck)
    # window descriptor (2 KiB) and a 2-byte content size (value - 256)
    f2 = _frame(0x40, bytes([1 << 3]) + struct.pack("<H", 300 - 256),
                _block(True, 1, 300) + b"q")
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    frames = skip + f1 + skip + f2
    assert zstd.content_size(frames) == 1500
    assert zstd.decompress(frames, "hand-made") == body + b"z" * 1000 + b"q" * 300
    bad = bytearray(f1)
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="hand-made: zstd: content checksum mismatch"):
        zstd.decompress(bytes(bad), "hand-made")
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(_frame(0x21, b"\x07\x00", _block(True, 0, 0)), "dict")
    with pytest.raises(ValueError, match="content size differs"):
        zstd.decompress(_frame(0x20, b"\x05", _block(True, 0, 3) + b"abc"), "fcs")


def test_checks_known_values():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


# ------------------------------------------------------ (b) malformed input


@pytest.fixture(scope="module")
def frame_with_checksum():
    return _compress(INPUTS["text"][:30_000], "19", True)


@pytest.mark.parametrize("cut", [0.0, 0.02, 0.3, 0.7, 0.999])
def test_truncated_frames_raise(frame_with_checksum, cut):
    frame = frame_with_checksum[: int(len(frame_with_checksum) * cut)]
    with pytest.raises(ValueError, match="layer.kernel: zstd: "):
        zstd.decompress_into(frame, np.empty(30_000, np.uint8), "layer.kernel")


def test_bit_flips_raise(frame_with_checksum):
    """Every single-bit flip after the frame header (blocks, tables,
    bitstreams, the checksum) of a checksummed frame raises ValueError."""
    frame = bytearray(frame_with_checksum)
    rng = np.random.default_rng(3)
    for pos in rng.choice(np.arange(6, len(frame)), 200, replace=False):
        flipped = frame.copy()
        flipped[pos] ^= 1 << int(rng.integers(8))
        with pytest.raises(ValueError, match="flip: zstd: "):
            zstd.decompress_into(bytes(flipped), np.empty(30_000, np.uint8), "flip")


def test_bad_magic_raises():
    frame = bytearray(_compress(b"abc" * 100, "1", False))
    frame[0] ^= 0xFF
    with pytest.raises(ValueError, match="f.zarray: zstd: bad magic"):
        zstd.decompress(bytes(frame), "f.zarray")


def test_no_compiler_raises(monkeypatch, tmp_path):
    """No decoder is built without a host compiler, and nothing falls back:
    the read raises naming the compiler."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CC", "no-such-cc-here")
    with pytest.raises(RuntimeError, match="no-such-cc-here"):
        zstd.decompress(_compress(b"abc", "1", False), "x")


# --------------------------------------------------------- (c) the JAX layout


def _tree():
    rng = np.random.default_rng(15)
    return {
        "params": {
            "conv": {"kernel": rng.normal(0, 0.02, (3, 3, 32, 64)).astype(np.float32),
                     "bias": rng.normal(0, 0.02, 64).astype(np.float32)},
            "bf": jnp.asarray(rng.normal(size=(5, 7)).astype(np.float32)).astype(jnp.bfloat16),
        },
        "step": np.int32(7),
        "f64": rng.normal(size=(4,)).astype(np.float64),
        "flags": np.array([True, False, True]),
        "u8": np.arange(9, dtype=np.uint8).reshape(3, 3),
        "lst": [np.arange(3, dtype=np.int64), np.ones((2, 2), np.float32)],
    }


def _same_leaf(want, got, where):
    """Bit-equal, dtype and shape; the port gives bfloat16 as a torch
    tensor, JAX as an ml_dtypes array."""
    if str(getattr(want, "dtype", "")) == "bfloat16":
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.bfloat16, where
            got = got.view(torch.int16).numpy()
        else:
            assert str(got.dtype) == "bfloat16", where
            got = np.asarray(got).view(np.int16)
        assert np.array_equal(np.asarray(want).view(np.int16), got), where
        return
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, (where, want.dtype, got.dtype,
                                                                 want.shape, got.shape)
    assert want.tobytes() == got.tobytes(), where


def _same_tree(want, got, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), (where, got)
        for k in want:
            _same_tree(want[k], got[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(want, got)):
            _same_tree(a, b, f"{where}[{i}]")
    else:
        _same_leaf(want, got, where)


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """The JAX package's save_checkpoint (OCDBT), and orbax's plain layout."""
    root = tmp_path_factory.mktemp("orbax")
    tree = _tree()
    jax_checkpoint.save_checkpoint(tree, str(root / "ocdbt"))
    # the plain layout, with the leaves as the JAX package saves them
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
        str(root / "plain"), args=ocp.args.PyTreeSave(jax.tree.map(np.asarray, tree)))
    return tree, root


@pytest.mark.parametrize("layout", ["ocdbt", "plain"])
def test_reads_jax_written_directories(jax_dirs, layout):
    tree, root = jax_dirs
    meta = json.loads((root / layout / "_METADATA").read_text())
    assert meta["use_ocdbt"] == (layout == "ocdbt")
    _same_tree(tree, ckpt.load_checkpoint(root / layout))


def test_jax_directory_holds_a_data_file_value(jax_dirs):
    """The float32 kernel (73 KiB, compressed ~68) is stored out of line in
    the process subdatabase's data file; the small leaves inline."""
    _, root = jax_dirs
    reader = OcdbtReader(root / "ocdbt")
    index = reader._index
    big = index[b"params.conv.kernel/0.0.0.0"]
    assert not isinstance(big, bytes) and big.file.path.startswith("ocdbt.process_0/d/")
    assert isinstance(index[b"step/0"], bytes)
    assert reader.list_keys() == sorted(reader.list_keys()) and "f64/.zarray" in reader.list_keys()


@pytest.fixture(scope="module")
def zarr_arrays(tmp_path_factory):
    """Arrays written by tensorstore in zarr v2: chunk grids with edge
    chunks, '.' and '/' separators, zstd and no compressor, some chunks
    never written (the fill value), over files and over OCDBT."""
    root = tmp_path_factory.mktemp("zarr")
    rng = np.random.default_rng(5)
    cases = {}
    for i, (sep, comp, dtype, fill, kv) in enumerate([
            (".", {"id": "zstd", "level": 5}, "<f4", 1.5, "file"),
            ("/", None, "<i4", 7, "file"),
            ("/", {"id": "zstd", "level": 1}, "<f8", None, "ocdbt"),
            (".", None, "|u1", 3, "ocdbt")]):
        base = {"driver": "file", "path": str(root / f"kv{i}")}
        store = base if kv == "file" else {"driver": "ocdbt", "base": f"file://{root}/kv{i}"}
        spec = {"driver": "zarr", "kvstore": {**store, "path": f"arr{i}/"} if kv == "ocdbt"
                else {**store, "path": f"{base['path']}/arr{i}/"},
                "metadata": {"shape": [7, 10, 3], "chunks": [3, 4, 2], "dtype": dtype,
                             "compressor": comp, "dimension_separator": sep,
                             "fill_value": fill},
                "create": True}
        arr = ts.open(spec).result()
        value = (rng.normal(size=(7, 10, 3)) * 50).astype(np.dtype(dtype))
        want = np.full((7, 10, 3), 0 if fill is None else fill, np.dtype(dtype))
        want[:4, 3:9] = value[:4, 3:9]  # chunks touched; others stay missing
        arr[:4, 3:9].write(value[:4, 3:9]).result()
        cases[i] = (root / f"kv{i}", kv, f"arr{i}", want)
    return cases


@pytest.mark.parametrize("case", range(4))
def test_zarr_chunk_grids(zarr_arrays, case):
    path, kv, name, want = zarr_arrays[case]
    store = zarr.DirStore(path) if kv == "file" else OcdbtReader(path)
    got = zarr.read_array(store, name)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------------- (d) height > 0


@pytest.mark.parametrize("manifest", ["single", "numbered"])
def test_ocdbt_btree_of_height_above_zero(tmp_path, manifest):
    rng = np.random.default_rng(9)
    config = {"max_decoded_node_bytes": 1024, "max_inline_value_bytes": 64,
              "manifest_kind": manifest}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/db",
                          "config": config}).result()
    for gen in range(3):  # three generations, overwriting some keys
        with ts.Transaction() as txn:
            for i in range(150):
                key = f"params.block{int(rng.integers(0, 40))}.layer{i}/{gen}.0"
                kv.with_transaction(txn)[key] = rng.bytes(int(rng.integers(0, 200)))
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    reader = OcdbtReader(tmp_path / "db")
    assert reader.height >= 2
    assert reader.list_keys() == sorted(want)
    assert all(reader.read(k) == v for k, v in want.items())
    assert reader.get("params.absent/0") is None


def test_bad_crc_in_an_ocdbt_node_raises(jax_dirs, tmp_path):
    _, root = jax_dirs
    copy = tmp_path / "copy"
    shutil.copytree(root / "ocdbt", copy)
    node = next((copy / "d").iterdir())
    data = bytearray(node.read_bytes())
    data[20] ^= 0x10
    node.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"{node.name}.*CRC-32C mismatch"):
        ckpt.load_checkpoint(copy)
    manifest = copy / "manifest.ocdbt"
    data = bytearray(manifest.read_bytes())
    data[0] ^= 1
    manifest.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="manifest.ocdbt: OCDBT: bad magic"):
        ckpt.load_checkpoint(copy)


# ----------------------------------------------------- (e) the JAX reader


def test_port_written_directory_reads_in_jax(jax_dirs, tmp_path):
    tree, root = jax_dirs
    ours = ckpt.load_checkpoint(root / "ocdbt")
    ckpt.save_checkpoint(ours, tmp_path / "ours")
    meta = json.loads((tmp_path / "ours" / "_METADATA").read_text())
    assert meta["use_ocdbt"] is False and meta["use_zarr3"] is False
    assert (tmp_path / "ours" / "_CHECKPOINT_METADATA").is_file()
    _same_tree(tree, jax_checkpoint.load_checkpoint(tree, str(tmp_path / "ours")))
    _same_tree(tree, ckpt.load_checkpoint(tmp_path / "ours"))
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save_checkpoint(ours, tmp_path / "ours")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ours"]  # no temporary left


def test_port_written_weights_load_in_jax_engine(tmp_path):
    model = truncated_lecun_normal_(InpaintNet(), torch.Generator().manual_seed(4))
    tree = flax_from_state_dict(model.state_dict())
    ckpt.save_checkpoint(tree, tmp_path / "inpaint")
    variables = _engine.load_variables(JaxInpaintNet(), (jnp.zeros((1, 16, 2)),
                                                         jnp.zeros((1, 16, 1))),
                                       str(tmp_path / "inpaint"))
    _same_tree(tree, {k: dict(v) for k, v in variables.items()})


# --------------------------------------------------------------- (g) zarr3


def test_zarr3_refused(tmp_path):
    tree = {"a": np.arange(4, dtype=np.float32)}
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
        str(tmp_path / "z3"), args=ocp.args.PyTreeSave(tree))
    with pytest.raises(NotImplementedError, match="zarr v3"):
        ckpt.load_checkpoint(tmp_path / "z3")


def test_other_compressors_refused(tmp_path):
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": str(tmp_path / "a")},
                   "metadata": {"shape": [4], "chunks": [4], "dtype": "<f4",
                                "compressor": {"id": "blosc"}}, "create": True}).result()
    arr.write(np.ones(4, np.float32)).result()
    with pytest.raises(NotImplementedError, match="blosc"):
        zarr.read_array(zarr.DirStore(tmp_path), "a")


# ------------------------------------------------------------- the fixture


def test_committed_fixture_matches_its_digests():
    """The fixture the card's host reads (chip_smoke.py phase 18 (c)): the
    JAX package's reader and the port's both give the digest file's
    leaves."""
    digests = json.loads(DIGESTS.read_text())
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size <= 512 * 1024
    ours = leaves(ckpt.load_checkpoint(FIXTURE))
    assert {k: digest(v) for k, v in ours.items()} == digests
    target = jax_checkpoint.load_checkpoint(seeded_tree(), str(FIXTURE))
    assert {k: digest(v) for k, v in leaves(target).items()} == digests
    reader = OcdbtReader(FIXTURE)
    assert not isinstance(reader._index[b"params.conv.kernel/0.0.0.0"], bytes)
    assert Path(FIXTURE, "_METADATA").is_file()


# ------------------------------------------------------------ random start


@pytest.mark.parametrize("family", ["tracknet", "inpaintnet", "yolo", "court"])
def test_train_apps_start_from_flax_truncated_lecun_normal(family):
    """init_weights draws Flax's default init: every conv and dense weight
    within 2 / 0.87962566 of zero in units of 1 / sqrt(fan_in) (a unit
    normal truncated at 2 and rescaled), zero biases, identity BatchNorm."""
    model = {"tracknet": lambda: make_tracknet(8, "concat")[0], "inpaintnet": InpaintNet,
             "yolo": lambda: YOLOv8("n", 1, num_keypoints=13),
             "court": lambda: ResNet50Regressor(num_outputs=24, stage_sizes=(1, 1, 1, 1))}[family]()
    init_weights(model)
    bound = 2 / _TRUNC2_STD * (1 + 1e-6)  # one float32 rounding of the rescale
    worst, n = 0.0, 0
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Linear)):
            w = m.weight.detach().double()
            z = w.abs().max().item() * math.sqrt(w[0].numel())
            worst = max(worst, z)
            n += w.numel()
            assert z <= bound, (m, z)
            assert m.bias is None or not m.bias.detach().any()
        elif isinstance(m, torch.nn.BatchNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.detach().any() and not m.running_mean.any()
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    # many draws reach near the truncation point: the bound is the binding one
    assert n > 10_000 and worst > 2 / _TRUNC2_STD * 0.95
