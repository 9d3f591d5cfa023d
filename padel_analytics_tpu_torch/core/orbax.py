"""Orbax checkpoint directories, the JAX package's format for any weights
path that is not a ``.msgpack`` file (``core/checkpoint.py`` and
``trackers/_engine.py`` there, through ``orbax.checkpoint``), read and
written without orbax or tensorstore.

A directory holds ``_METADATA`` (JSON: ``tree_metadata`` keyed by each
leaf's path, whose ``key_metadata`` gives every key with its ``key_type``,
2 a dict key and 1 a sequence index; ``use_ocdbt``, ``use_zarr3``),
``_CHECKPOINT_METADATA``, and one zarr v2 array a leaf, named by its keys
joined with "." (core/zarr.py). With ``"use_ocdbt": true`` (orbax's
default) the arrays are keys of an OCDBT database at the directory's root
(core/ocdbt.py); otherwise each is a plain directory.

`load` returns the variable tree (nested dicts and lists of numpy arrays,
``torch.bfloat16`` tensors for bfloat16), as `checkpoint.load_checkpoint`
does for a ``.msgpack``. `save` writes the plain layout (``"use_ocdbt":
false``, uncompressed chunks), which orbax reads; it writes into a
temporary sibling and renames it at the end, and refuses an existing
destination, as orbax does.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np

from . import zarr
from .ocdbt import OcdbtReader

_DICT_KEY, _SEQ_KEY = 2, 1
#: value_type of leaves orbax writes with no array: what they restore to.
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}


def _store(path: Path, meta: dict):
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{path}: a zarr v3 checkpoint (\"use_zarr3\": true) is not "
                                  "supported; save it with use_zarr3=False")
    use_ocdbt = meta.get("use_ocdbt", (path / "manifest.ocdbt").is_file())
    return OcdbtReader(path) if use_ocdbt else zarr.DirStore(path)


def _put(tree: dict, keys: list, value) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _lists(node, kinds: dict, path: tuple = ()):
    """Dicts whose keys are sequence indices back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v, kinds, path + (k,)) for k, v in node.items()}
    if out and all(kinds.get(path + (k,)) == _SEQ_KEY for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


def load(path) -> Any:
    """The variable tree of the orbax checkpoint directory `path`."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"{path}: no such orbax checkpoint directory")
    try:
        meta = json.loads((path / "_METADATA").read_text())
    except FileNotFoundError as e:
        raise ValueError(f"{path}: not an orbax checkpoint (no _METADATA)") from e
    store = _store(path, meta)
    tree: dict = {}
    kinds: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        for i, k in enumerate(entry["key_metadata"]):
            kinds[tuple(keys[: i + 1])] = k["key_type"]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in _EMPTY:
            _put(tree, keys, _EMPTY[value_type]())
        elif value_type in ("np.ndarray", "jax.Array", "scalar"):
            value = zarr.read_array(store, ".".join(map(str, keys)))
            _put(tree, keys, value[()].item() if value_type == "scalar" else value)
        else:
            raise NotImplementedError(f"{path}: leaf {'.'.join(map(str, keys))} has value_type "
                                      f"{value_type!r}, which is not supported")
    return _lists(tree, kinds)


def _leaves(tree, keys: tuple = (), kinds: tuple = ()):
    """(keys, key types, leaf) of every leaf, dicts in their own order."""
    if isinstance(tree, dict):
        if not tree:
            yield keys, kinds, tree
        for k, v in tree.items():
            yield from _leaves(v, keys + (str(k),), kinds + (_DICT_KEY,))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            yield keys, kinds, tree
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + (str(i),), kinds + (_SEQ_KEY,))
    else:
        yield keys, kinds, tree


def _value_type(leaf) -> str:
    if leaf is None:
        return "None"
    if isinstance(leaf, dict):
        return "Dict"
    if isinstance(leaf, (list, tuple)):
        return "List"
    if isinstance(leaf, (int, float)):
        return "scalar"
    return "np.ndarray"


def save(tree, path) -> None:
    """Write `tree` (nested dicts and lists of numpy arrays, torch tensors
    or Python numbers) as an orbax checkpoint directory at `path`."""
    path = Path(path).absolute()
    if path.exists():
        raise ValueError(f"Destination {path} already exists.")
    start = time.time_ns()
    tmp = path.with_name(f"{path.name}.orbax-checkpoint-tmp-{start}")
    tmp.mkdir(parents=True)
    try:
        metadata = {}
        for keys, kinds, leaf in _leaves(tree):
            if not keys:
                raise ValueError("the tree's root must be a dict or a list")
            value_type = _value_type(leaf)
            if value_type not in _EMPTY:
                zarr.write_array(tmp / ".".join(keys),
                                 np.asarray(leaf) if value_type == "scalar" else leaf)
            metadata[str(keys)] = {
                "key_metadata": [{"key": k, "key_type": t} for k, t in zip(keys, kinds)],
                "value_metadata": {"value_type": value_type,
                                   "skip_deserialize": value_type in _EMPTY}}
        (tmp / "_METADATA").write_text(json.dumps({
            "tree_metadata": metadata, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
        (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
            "item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                             "StandardCheckpointHandler",
            "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": start,
            "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}))
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
