"""The train apps' checkpoints: `.pt` files in the formats the port's own
loaders (and the reference's) read, or the JAX package's Flax `.msgpack`
and orbax directories.

- TrackNet: ``{'model': state_dict, 'param_dict': {'seq_len', 'bg_mode'}}``
  (the reference's format, `BallTracker(tracking_model_path=...)`);
- InpaintNet: the same, with the reference's ``buttleneck.conv_k`` names
  (`BallTrackerConfig(inpainting_model_path=...)`);
- YOLOv8: a state_dict under ultralytics' names (``model.{i}.``,
  ``m.{k}``, ``model.22.cv2/cv3/cv4.{scale}.{0,1,2}``, the DFL's arange),
  which `PlayerTracker`, `PlayerKeypointsTracker` and the yolo court read;
- ResNet-50: a state_dict under torchvision's names, which the resnet
  court reads.

A path ending in ``.pt`` / ``.pth`` is torch's; any other is the JAX
package's format, for every family (`core/checkpoint.py::
checkpoint_format`): a ``.msgpack`` file, or else an orbax checkpoint
directory (written in orbax's plain per-array layout; the path must not
exist yet), each holding the ``{'params', 'batch_stats'}`` tree its
`_engine.load_variables` builds for the same model (`models/convert.py::
flax_from_state_dict`, no param_dict), which its trackers and apps load.
`load_for_resume` reads each back, the reference's own files and the JAX
package's.

A model sharded over the mesh's 'model' axis is saved whole: the apps
gather its shards on every rank first (`parallel.gather_params`), then
global rank 0 writes the bytes an unsharded model with the same values
writes; a save of a sharded model raises ValueError. `--resume` loads the
whole tree into the unsharded model, which the apps then shard.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from ..core.checkpoint import checkpoint_format
from ..models.convert import (
    _HEAD_BRANCH,
    _HEAD_LAYER,
    _YOLO_LAYERS,
    convert_inpaintnet_checkpoint,
    convert_tracknet_checkpoint,
    load_flax_state_dict,
    load_torch_checkpoint,
    save_flax,
)
from ..models.yolov8 import REG_MAX
from ..parallel.tensor_parallel import is_sharded

#: ultralytics' layer index of the YOLOv8 detect / pose head.
YOLO_HEAD_INDEX = 22


def _cpu(state_dict) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in state_dict.items()}


def _whole(model: nn.Module, path) -> bool:
    """Refuse a model whose weights are shards; whether `path` is in the JAX
    package's format (.msgpack or an orbax directory)."""
    if is_sharded(model):
        raise ValueError(f"saving {path}: the model is sharded over the 'model' axis; call "
                         "parallel.gather_params(model, mesh) on every rank first")
    return checkpoint_format(path, load=False) != "torch"


def _save(obj, path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(obj, path)


# ------------------------------------------------------------------ names


def inpaintnet_reference_names(state_dict) -> dict[str, torch.Tensor]:
    """The port's InpaintNet names -> the reference's (``bottleneck_k`` is
    ``buttleneck.conv_k`` there)."""
    out = {}
    for key, value in state_dict.items():
        for i in (1, 2):
            if key.startswith(f"bottleneck_{i}."):
                key = f"buttleneck.conv_{i}." + key[len(f"bottleneck_{i}."):]
        out[key] = value
    return out


_YOLO_INDEX = {v: k for k, v in _YOLO_LAYERS.items()}
_BRANCH_CV = {v: k for k, v in _HEAD_BRANCH.items()}
_LAYER_INDEX = {v: k for k, v in _HEAD_LAYER.items()}


def ultralytics_key(key: str, head_index: int = YOLO_HEAD_INDEX) -> str:
    """A port YOLOv8 name -> ultralytics' (the inverse of
    convert._yolo_key)."""
    first, *rest = key.split(".")
    branch, _, scale = first.rpartition("_")
    if branch in _BRANCH_CV and scale.isdigit():
        layer, *leaf = rest
        return ".".join(["model", str(head_index), _BRANCH_CV[branch], scale,
                         _LAYER_INDEX[layer], *leaf])
    rest = [f"m.{p[2:]}" if p.startswith("m_") and p[2:].isdigit() else p for p in rest]
    return ".".join(["model", _YOLO_INDEX[first], *rest])


def yolov8_ultralytics_state_dict(state_dict) -> dict[str, torch.Tensor]:
    """The port's YOLOv8 state_dict -> ultralytics' names, with the DFL
    conv's frozen arange the port's closed-form decode drops."""
    out = {ultralytics_key(k): v for k, v in state_dict.items()}
    out[f"model.{YOLO_HEAD_INDEX}.dfl.conv.weight"] = torch.arange(
        REG_MAX, dtype=torch.float32).view(1, REG_MAX, 1, 1)
    return out


def torchvision_resnet_key(key: str) -> str:
    """A port ResNet50Regressor name -> torchvision resnet50's (the inverse
    of convert.convert_resnet50_state_dict)."""
    parts = key.split(".")
    if parts[0] == "fc":
        return key
    if parts[0].startswith("layer"):
        stage, block = parts[0].split("_")
        parts = [stage, block] + parts[1:]
    i = len(parts) - 3  # ... convK|down_conv, conv|bn, leaf
    mod, sub = parts[i], parts[i + 1]
    if mod == "down_conv":
        parts[i: i + 2] = ["downsample", "0" if sub == "conv" else "1"]
    else:
        parts[i: i + 2] = [mod if sub == "conv" else f"bn{mod[4:]}"]
    return ".".join(parts)


# ------------------------------------------------------------------- save


def save_tracknet(path, model: nn.Module, seq_len: int, bg_mode: str = "concat") -> None:
    if _whole(model, path):
        return save_flax(path, model)
    _save({"model": _cpu(model.state_dict()),
           "param_dict": {"model_name": "TrackNet", "seq_len": seq_len, "bg_mode": bg_mode}},
          path)


def save_inpaintnet(path, model: nn.Module, seq_len: int = 16) -> None:
    if _whole(model, path):
        return save_flax(path, model)
    _save({"model": inpaintnet_reference_names(_cpu(model.state_dict())),
           "param_dict": {"model_name": "InpaintNet", "seq_len": seq_len}}, path)


def save_yolov8(path, model: nn.Module) -> None:
    if _whole(model, path):
        return save_flax(path, model)
    _save(yolov8_ultralytics_state_dict(_cpu(model.state_dict())), path)


def save_resnet(path, model: nn.Module) -> None:
    if _whole(model, path):
        return save_flax(path, model)
    _save({torchvision_resnet_key(k): v for k, v in _cpu(model.state_dict()).items()}, path)


# ------------------------------------------------------------------- load


def load_for_resume(family: str, path) -> dict[str, torch.Tensor]:
    """The port's state_dict of `family` ('tracknet', 'inpaintnet', 'yolo',
    'resnet') from a file the train apps write, the reference's own, or the
    JAX package's .msgpack or orbax directory."""
    if family not in ("tracknet", "inpaintnet", "yolo", "resnet"):
        raise ValueError(f"unknown model family {family!r}")
    if checkpoint_format(path) != "torch":
        return load_flax_state_dict(path)
    path = str(path)
    if family == "tracknet":
        return convert_tracknet_checkpoint(load_torch_checkpoint(path))[0]
    if family == "inpaintnet":
        return convert_inpaintnet_checkpoint(load_torch_checkpoint(path))[0]
    if family == "yolo":
        from ..trackers.players import _load_yolo

        return _load_yolo(path)
    from ..trackers.court_keypoints import _load_resnet

    return _load_resnet(path)
