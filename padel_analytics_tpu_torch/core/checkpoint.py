"""The JAX package's variable checkpoints: Flax ``.msgpack`` files, read and
written with the standard library and numpy, and orbax checkpoint
directories (core/orbax.py).

Counterpart of ``padel_analytics_tpu/core/checkpoint.py``, with its rule: a
path ending in ``.msgpack`` is a Flax file (``serialization.to_bytes`` /
``from_bytes``), any other path an orbax directory (`checkpoint_format`;
the port's own ``.pt`` / ``.pth`` files are torch's and are not read here).
The JAX package's trackers load both and its train apps write both.

The ``.msgpack`` format is msgpack
(``msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)`` in
``flax/serialization.py``) with three extension types:

- ext 1, an ndarray: its payload is itself msgpack, the array
  ``(shape, dtype name, C-order bytes)``; ``bfloat16`` (no numpy dtype) is
  read as its uint16 bits and given as a ``torch.bfloat16`` tensor;
- ext 2, a Python complex: the payload is the array ``(real, imag)``;
- ext 3, a numpy scalar: an ndarray of shape ``()``, unpacked.

An array over `MAX_CHUNK_SIZE` bytes is stored as
``{'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
{'0': flat chunk, ...}}``, as Flax writes it. The codec reads every width of
the msgpack subset Flax writes (nil, bool, ints, float32/64, str, bin,
arrays, maps and ext in their fix / 8 / 16 / 32 forms) and writes the
smallest form, as msgpack's packer does. Anything else (an unknown ext
code, a reserved byte, a truncated or over-long buffer) raises ValueError.

The msgpack package is not used (the card's machine has none), nor orbax
or tensorstore.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from . import orbax

#: Flax's bound on one array leaf's bytes before it is chunked.
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------- read


class _Reader:
    """One msgpack object from `data` at a time. `raw`: str arrives as
    bytes (Flax reads an ndarray's payload so). `path` names the map keys
    above the object being read, for errors."""

    def __init__(self, data: bytes, raw: bool = False, path: tuple = ()):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.path = list(path)

    def _where(self) -> str:
        return "/".join(map(str, self.path)) or "<root>"

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (want {n} more) "
                             f"under {self._where()}")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack: map key {key!r} under {self._where()} is not a "
                                 "string")
            self.path.append(key)
            out[key] = self.read()
            self.path.pop()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_unpack(code, self.take(n), tuple(self.path))

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack((">B", ">H", ">I")[b - 0xC7]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self.unpack((">B", ">H", ">I", ">Q")[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack((">b", ">h", ">i", ">q")[b - 0xD0])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack((">H", ">I")[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack((">H", ">I")[b - 0xDE]))
        raise ValueError(f"msgpack: reserved byte 0x{b:02x} at {self.pos - 1} under "
                         f"{self._where()}")


def _unpackb(data, raw: bool = False, path: tuple = ()):
    reader = _Reader(data, raw, path)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object "
                         f"under {'/'.join(map(str, path)) or '<root>'}")
    return obj


def _ndarray_from_bytes(data, path: tuple):
    where = "/".join(map(str, path)) or "<root>"
    payload = _unpackb(data, raw=True, path=path)
    if not (isinstance(payload, list) and len(payload) == 3):
        raise ValueError(f"msgpack: ndarray payload at {where} is not (shape, dtype, bytes)")
    shape, name, buffer = payload
    if not (isinstance(shape, list) and all(isinstance(s, int) for s in shape)
            and isinstance(name, bytes) and isinstance(buffer, bytes)):
        raise ValueError(f"msgpack: ndarray payload at {where} is not (shape, dtype, bytes)")
    if name == b"bfloat16":
        bits = np.frombuffer(buffer, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name.decode())
    except TypeError as e:
        raise ValueError(f"msgpack: array at {where} has dtype {name.decode()!r}, which "
                         "numpy does not know") from e
    if dtype.hasobject:
        raise ValueError(f"msgpack: array at {where} has an object dtype")
    if len(buffer) != dtype.itemsize * int(np.prod(shape)):
        raise ValueError(f"msgpack: array at {where}: {len(buffer)} bytes for shape {shape} "
                         f"{dtype}")
    return np.frombuffer(buffer, dtype).reshape(shape).copy()


def _ext_unpack(code: int, data, path: tuple):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data, path)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data, path)[()]
    if code == _EXT_COMPLEX:
        pair = _unpackb(data, path=path)
        if not (isinstance(pair, list) and len(pair) == 2):
            raise ValueError(f"msgpack: complex at {'/'.join(map(str, path))} is not (re, im)")
        return complex(pair[0], pair[1])
    raise ValueError(f"msgpack: unknown ext type {code} at {'/'.join(map(str, path)) or '<root>'}"
                     " (Flax writes 1, 2 and 3)")


def _unchunk(tree):
    """Chunked array leaves (maps) back into arrays, as Flax's
    `_unchunk_array_leaves_in_place`."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if all(isinstance(c, torch.Tensor) for c in chunks):  # bfloat16
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Flax msgpack bytes -> the nested dict of arrays (numpy; torch.bfloat16
    tensors for bfloat16), as `flax.serialization.msgpack_restore` gives."""
    return _unchunk(_unpackb(bytes(data)))


# -------------------------------------------------------------------- write


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= top:
                out += bytes([tag]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} is too large")
    else:
        for tag, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000), (0xD3, ">q", -2**63)):
            if v >= low:
                out += bytes([tag]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} is too small")


def _sized(out: bytearray, n: int, fix: int | None, fix_max: int, tags) -> None:
    """The header of a str / bin / array / map of n items: the fix form
    when there is one and n fits it, else the smallest of tags (8, 16, 32
    bit lengths; None where the kind has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            out += bytes([tag]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: {n} items is too long")


def _ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _sized(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + payload


def _ndarray_to_bytes(arr) -> bytes:
    """(shape, dtype name, C-order bytes), packed as Flax's
    `_ndarray_to_bytes`."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            return _packb([list(arr.shape), "bfloat16",
                           arr.contiguous().view(torch.int16).numpy().tobytes("C")])
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of "
                         "ndarrays.")
    return _packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _int(out, obj)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        b = obj.encode("utf-8")
        _sized(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif t in (bytes, bytearray, memoryview):
        b = bytes(obj)
        _sized(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif t is list:
        _sized(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _sized(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif t is complex:
        _ext(out, _EXT_COMPLEX, _packb([obj.real, obj.imag]))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _packb(obj) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _chunk_leaves(tree):
    """Array leaves over MAX_CHUNK_SIZE bytes -> Flax's chunked form."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        itemsize = tree.itemsize if isinstance(tree, np.ndarray) else tree.element_size()
        n = tree.size if isinstance(tree, np.ndarray) else tree.numel()
        if n * itemsize <= MAX_CHUNK_SIZE:
            return tree
        size = max(1, int(MAX_CHUNK_SIZE / itemsize))
        flat = tree.reshape(-1)
        chunks = [flat[i: i + size] for i in range(0, n, size)]
        return {_CHUNKED: True, "shape": {str(i): s for i, s in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def msgpack_serialize(tree) -> bytes:
    """A nested dict (lists, Python scalars, str, bytes, numpy arrays and
    scalars, torch tensors) -> Flax msgpack bytes, which
    `flax.serialization.from_bytes` / `msgpack_restore` read. Map order is
    the dicts' own, as `flax.serialization.to_bytes` writes it."""
    return _packb(_chunk_leaves(tree))


# -------------------------------------------------------------------- files


def checkpoint_format(path, what: str = "checkpoint", load: bool = True) -> str:
    """'torch' for a ``.pt`` / ``.pth`` file (the port's own rule), 'flax'
    for ``.msgpack``, 'orbax' for any other path, which must be a directory,
    as the JAX package decides. To `load`, a path that does not exist
    raises FileNotFoundError (nothing falls back to random weights), any
    other file ValueError; both name `what`. A path to save to is not
    looked at."""
    path = str(path)
    if load and not os.path.exists(path):
        raise FileNotFoundError(f"{what} {path} not found")
    if path.endswith((".pt", ".pth")):
        return "torch"
    if path.endswith(".msgpack"):
        return "flax"
    if load and not os.path.isdir(path):
        raise ValueError(f"unsupported {what} {path!r} (want a .pt, .pth or .msgpack file, or "
                         "an orbax checkpoint directory)")
    return "orbax"


def save_checkpoint(variables: Any, path) -> None:
    """Write a variable tree: a Flax file for a path ending in ``.msgpack``,
    else an orbax directory (which must not exist yet)."""
    path = Path(path)
    if checkpoint_format(path, load=False) != "flax":
        return orbax.save(variables, path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(_state_dict(variables)))


def _state_dict(tree):
    """Flax's ``to_state_dict``, as its ``to_bytes`` writes a tree: a list,
    tuple or named tuple as a dict keyed by "0", "1", ... (or its fields),
    dict keys as str."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def load_checkpoint(target: Any = None, path=None):
    """A Flax .msgpack file or an orbax directory -> its variable tree
    (nested dicts of arrays): ``load_checkpoint(path)``.

    ``load_checkpoint(target, path)`` restores into the structure of
    `target`, as the JAX package's does (a `target` of None is no target).
    From a ``.msgpack`` as ``flax.serialization.from_bytes``: each of
    target's dict keys must be in the file (the file's others are dropped),
    lists, tuples and named tuples must match in length and fields, and every
    leaf comes as the file holds it. From an orbax directory as
    ``StandardCheckpointer.restore(target=)``: the keys and lengths must match
    exactly, and every leaf is cast to the dtype of target's (as
    ``np.asarray`` gives it); its shape is the file's. A mismatch raises
    ValueError."""
    if path is None:
        target, path = None, target
    fmt = checkpoint_format(path)
    tree = orbax.load(path) if fmt == "orbax" else msgpack_restore(Path(path).read_bytes())
    if target is None:
        return tree
    return _restore(target, tree, strict=fmt == "orbax", where=str(path))


def _restore(target, state, strict: bool, where: str):
    """`state` (a loaded tree; a msgpack holds lists and named tuples as
    dicts) in the structure of `target`; `strict`: orbax's rules, else
    Flax's (see `load_checkpoint`)."""
    fields = getattr(target, "_fields", None)  # a named tuple
    if isinstance(target, dict) or (fields is not None and isinstance(state, dict)):
        keys = {str(k): k for k in (target if fields is None else fields)}
        if not isinstance(state, dict):
            raise ValueError(f"{where}: a dict in the target, {type(state).__name__} in the file")
        missing = set(keys) - set(state)
        extra = set(state) - set(keys) if strict or fields is not None else set()
        if missing or extra:
            raise ValueError(f"{where}: the keys {sorted(missing)} of the target are not in the "
                             f"file, {sorted(extra)} of the file not in the target")
        if fields is not None:
            return type(target)(**{f: _restore(getattr(target, f), state[f], strict,
                                               f"{where}/{f}") for f in fields})
        # orbax restores through a JAX tree, whose dicts are in key order
        return {keys[k]: _restore(target[keys[k]], state[k], strict, f"{where}/{k}")
                for k in (sorted(keys) if strict else keys)}
    if isinstance(target, (list, tuple)):
        if not strict:  # Flax's state dict of a sequence: keys "0", "1", ...
            if not (isinstance(state, dict) and set(state) == set(map(str, range(len(state))))):
                raise ValueError(f"{where}: a sequence in the target, {type(state).__name__} "
                                 "in the file")
            state = [state[str(i)] for i in range(len(state))]
        if not isinstance(state, (list, tuple)) or len(state) != len(target):
            got = len(state) if isinstance(state, (list, tuple)) else type(state).__name__
            raise ValueError(f"{where}: a sequence of {len(target)} in the target, {got} in "
                             "the file")
        items = [_restore(t, v, strict, f"{where}/{i}")
                 for i, (t, v) in enumerate(zip(target, state))]
        if fields is not None:
            return type(target)(*items)
        return tuple(items) if isinstance(target, tuple) else items
    return _cast(state, target) if strict and target is not None else state


def _cast(leaf, like):
    """An orbax leaf cast to the dtype of the target leaf `like`: numpy, or a
    torch.bfloat16 tensor for bfloat16 (numpy has none)."""
    if isinstance(like, torch.Tensor):
        bf16 = like.dtype == torch.bfloat16
        dtype = None if bf16 else like.new_empty(0).numpy().dtype
    else:
        dtype = np.asarray(like).dtype
        bf16 = dtype.name == "bfloat16"
    if bf16:
        return torch.as_tensor(leaf).to(torch.bfloat16)
    if isinstance(leaf, torch.Tensor):  # a bfloat16 leaf to another dtype
        leaf = leaf.float().numpy()
    return np.asarray(leaf).astype(dtype)
