"""zarr v2 arrays, as orbax stores each leaf of a checkpoint: a ``.zarray``
JSON and its chunks, under the key prefix ``<leaf name>/``.

Read over either store orbax uses: an OCDBT database (`ocdbt.OcdbtReader`)
or plain files in one directory per array (`DirStore`). C order, the "."
and "/" dimension separators, several chunks (edge chunks are stored whole
and cut here), a missing chunk read as the fill value, 0-d arrays (one
chunk, key "0"); compressors ``zstd`` (through core/zstd.py) and none.
Dtypes: every fixed-size numpy number and ``|b1``, and ``bfloat16``, read as
a ``torch.bfloat16`` tensor (numpy has no such dtype) as the msgpack reader
gives it.

Written: one chunk, no compressor, in the plain per-array layout
(`write_array`). A zarr v3 array, another compressor, a filter or Fortran
order raise NotImplementedError naming it.
"""

from __future__ import annotations

import json
import math
from itertools import product
from pathlib import Path

import numpy as np
import torch

from . import zstd

_BF16 = "bfloat16"


class DirStore:
    """Keys as files under `root` ("a/.zarray" is root/a/.zarray)."""

    def __init__(self, root):
        self.root = Path(root)

    def get(self, key: str):
        try:  # one open, no stat: a checkpoint is hundreds of small files
            with open(self.root / key, "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            return None


def _dtype(name: str, where: str) -> np.dtype:
    if name == _BF16:
        return np.dtype("<u2")
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise NotImplementedError(f"{where}: zarr dtype {name!r} is not supported") from e
    if dtype.kind not in "biufc" or dtype.hasobject:
        raise NotImplementedError(f"{where}: zarr dtype {name!r} is not supported")
    return dtype


def _fill(value, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value.replace("Infinity", "inf"))
    if bf16:  # the fill value's bfloat16 bits
        return int(torch.tensor(value, dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
    return value


def read_array(store, name: str):
    """The array stored under `name` in `store` (an object with
    ``get(key) -> bytes | None``): a numpy array, or a torch.bfloat16
    tensor."""
    where = f"{getattr(store, 'root', '')}/{name}"
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        if store.get(f"{name}/zarr.json") is not None:
            raise NotImplementedError(f"{where}: a zarr v3 array (zarr.json) is not supported")
        raise ValueError(f"{where}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{where}: zarr_format {meta.get('zarr_format')} "
                                  "is not supported (zarr v2 only)")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"{where}: order {meta['order']!r} is not supported")
    if meta.get("filters"):
        raise NotImplementedError(f"{where}: zarr filters {meta['filters']} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise NotImplementedError(f"{where}: zarr compressor {compressor.get('id')!r} is not "
                                  "supported (zstd or none)")
    bf16 = meta["dtype"] == _BF16
    dtype = _dtype(meta["dtype"], where)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise ValueError(f"{where}: chunks {chunks} do not fit shape {shape}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{where}: dimension_separator {sep!r}")
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    one = chunks == shape  # one chunk, the whole array (as orbax writes): decoded in place
    out = None if one else np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
    for index in product(*grid):
        key = sep.join(map(str, index)) if index else "0"
        data = store.get(f"{name}/{key}")
        if data is None:
            if one:
                out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
            continue  # the fill value
        what = f"{where}/{key}"
        if compressor is None:
            if len(data) != math.prod(chunks) * dtype.itemsize:
                raise ValueError(f"{what}: {len(data)} bytes, expected "
                                 f"{math.prod(chunks) * dtype.itemsize}")
            chunk = np.frombuffer(data, dtype).reshape(chunks)
        else:
            chunk = np.empty(chunks, dtype)
            zstd.decompress_into(data, chunk, what)
        if one:
            out = chunk if chunk.flags.writeable else chunk.copy()
            continue
        box = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[box] = chunk[tuple(slice(0, b.stop - b.start) for b in box)]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _as_numpy(value) -> tuple[np.ndarray, str]:
    """(C-order array, zarr dtype) of a leaf: numpy, a torch tensor (bfloat16
    by its bits) or a Python / numpy scalar."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view("<u2"), _BF16
        value = value.numpy()
    arr = np.asarray(value, order="C")  # ascontiguousarray would make a 0-d array 1-d
    if arr.dtype.kind not in "biufc" or arr.dtype.hasobject:
        raise TypeError(f"cannot write a {arr.dtype} array as zarr")
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return arr, arr.dtype.str


def write_array(directory, value) -> None:
    """`value` as a zarr v2 array in `directory` (created): ``.zarray`` and
    one uncompressed chunk, as orbax's plain layout reads it."""
    arr, dtype = _as_numpy(value)
    directory = Path(directory)
    directory.mkdir(parents=True)
    meta = {"chunks": [max(1, s) for s in arr.shape], "compressor": None,
            "dimension_separator": ".", "dtype": dtype, "fill_value": None, "filters": None,
            "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    (directory / ".zarray").write_text(json.dumps(meta, sort_keys=True, separators=(",", ":")))
    if arr.size:
        key = ".".join("0" for _ in arr.shape) or "0"
        (directory / key).write_bytes(arr.tobytes("C"))
