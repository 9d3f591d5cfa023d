"""Weights carried into the port's torch modules.

Counterpart of ``padel_analytics_tpu/models/convert.py``, in the other
direction: `tracknet_state_dict_from_flax` maps the JAX package's
``{'params', 'batch_stats'}`` variable tree (as numpy arrays) onto a torch
``state_dict``, the inverse of the JAX package's conversion rules:

- kernel (Kh, Kw, I, O)  -> weight (O, I, Kh, Kw)
- bn scale / bias        -> bn weight / bias
- bn mean / var          -> bn running_mean / running_var

The reference's own TrackNet checkpoints (``{'model': state_dict,
'param_dict': {...}}``) already use the port's names and layouts and load
as they are.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _walk(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def tracknet_state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX TrackNet variables -> a state_dict for the port's TrackNet."""
    out: dict[str, torch.Tensor] = {}
    for path, value in _walk(variables["params"]):
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            if value.ndim != 4:
                raise ValueError(f"unhandled kernel shape {value.shape} at {module}")
            out[f"{module}.weight"] = torch.from_numpy(
                np.ascontiguousarray(value.transpose(3, 2, 0, 1), np.float32))
        elif leaf in ("scale", "bias"):
            name = "weight" if leaf == "scale" else "bias"
            out[f"{module}.{name}"] = torch.from_numpy(np.asarray(value, np.float32))
        else:
            raise ValueError(f"unhandled parameter {'/'.join(path)}")
    for path, value in _walk(variables.get("batch_stats", {})):
        module, leaf = ".".join(path[:-1]), path[-1]
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unhandled batch stat {'/'.join(path)}")
        out[f"{module}.{names[leaf]}"] = torch.from_numpy(np.asarray(value, np.float32))
        out.setdefault(f"{module}.num_batches_tracked", torch.tensor(0))
    return out


def convert_tracknet_checkpoint(ckpt: Mapping[str, Any]) -> tuple[dict, dict]:
    """Split a reference TrackNet checkpoint into (state_dict, param_dict)."""
    state_dict = ckpt["model"] if "model" in ckpt else ckpt
    return dict(state_dict), dict(ckpt.get("param_dict", {}))


def load_torch_checkpoint(path: str):
    """torch.load a reference .pt checkpoint without unpickling code
    (``weights_only=True``; TrackNet's dict checkpoints need nothing more)."""
    return torch.load(path, map_location="cpu", weights_only=True)
