"""Weights carried into the port's torch modules.

Counterpart of ``padel_analytics_tpu/models/convert.py``, in the other
direction where the source is the JAX package: `state_dict_from_flax` maps
a ``{'params', 'batch_stats'}`` variable tree (as numpy arrays) onto a torch
``state_dict``. The port's submodule names equal the Flax tree's (TrackNet,
YOLOv8 and InpaintNet alike; ResNet-50 keeps each conv and its BN under one
ConvBN, so ``convN`` / ``bnN`` become ``convN.conv`` / ``convN.bn``), so the
bridge inverts the layouts:

- kernel (Kh, Kw, I, O)  -> weight (O, I, Kh, Kw)
- kernel (K, I, O)       -> Conv1d weight (O, I, K)
- kernel (I, O)          -> Linear weight (O, I)
- bn scale / bias        -> bn weight / bias
- bn mean / var          -> bn running_mean / running_var

The reference's own TrackNet checkpoints (``{'model': state_dict,
'param_dict': {...}}``) already use the port's names and layouts and load
as they are; its InpaintNet checkpoints only rename ``buttleneck.conv_k``
to ``bottleneck_k``. ultralytics YOLOv8 checkpoints (``model.{i}.`` layer
indices, ``m.{k}`` bottlenecks, ``cv2/cv3/cv4.{scale}.{0,1,2}`` head
branches) are renamed by `yolov8_state_dict_from_ultralytics`, and
torchvision's resnet50 by `convert_resnet50_state_dict`, with no
transposes.
"""

from __future__ import annotations

import sys
import types
from typing import Any, Mapping

import numpy as np
import torch


def _walk(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


#: Kernel layout (Flax) -> weight layout (torch), by the kernel's rank.
_KERNEL_AXES = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def _resnet_module(path: tuple[str, ...]) -> str:
    """A ResNet50Regressor Flax module path -> the port's: each BN joins the
    conv it follows in one ConvBN."""
    *parent, last = path
    if last.startswith("bn"):
        last = f"conv{last[2:]}.bn"
    elif last == "down_bn":
        last = "down_conv.bn"
    elif last.startswith("conv") or last == "down_conv":
        last = f"{last}.conv"
    return ".".join([*parent, last])


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX variables (TrackNet, YOLOv8, InpaintNet, ResNet50Regressor) -> a
    state_dict for the port's module of the same architecture."""
    out: dict[str, torch.Tensor] = {}
    params = variables["params"]
    # ResNet50Regressor's tree: the stem's bn1 and the fc at its top.
    module_name = _resnet_module if {"bn1", "fc"} <= set(params) else ".".join
    for path, value in _walk(params):
        module, leaf = module_name(path[:-1]), path[-1]
        if leaf == "kernel":
            if value.ndim not in _KERNEL_AXES:
                raise ValueError(f"unhandled kernel shape {value.shape} at {module}")
            out[f"{module}.weight"] = torch.from_numpy(
                np.ascontiguousarray(value.transpose(_KERNEL_AXES[value.ndim]), np.float32))
        elif leaf in ("scale", "bias"):
            name = "weight" if leaf == "scale" else "bias"
            out[f"{module}.{name}"] = torch.from_numpy(np.asarray(value, np.float32))
        else:
            raise ValueError(f"unhandled parameter {'/'.join(path)}")
    for path, value in _walk(variables.get("batch_stats", {})):
        module, leaf = module_name(path[:-1]), path[-1]
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unhandled batch stat {'/'.join(path)}")
        out[f"{module}.{names[leaf]}"] = torch.from_numpy(np.asarray(value, np.float32))
        out.setdefault(f"{module}.num_batches_tracked", torch.tensor(0))
    return out


#: The ball path's name for the bridge.
tracknet_state_dict_from_flax = state_dict_from_flax


def convert_tracknet_checkpoint(ckpt: Mapping[str, Any]) -> tuple[dict, dict]:
    """Split a reference TrackNet checkpoint into (state_dict, param_dict)."""
    state_dict = ckpt["model"] if "model" in ckpt else ckpt
    return dict(state_dict), dict(ckpt.get("param_dict", {}))


def convert_inpaintnet_checkpoint(ckpt: Mapping[str, Any]) -> tuple[dict, dict]:
    """Split a reference InpaintNet checkpoint (``{'model': state_dict,
    'param_dict': {...}}``) into (the port's state_dict, param_dict): the
    reference's ``buttleneck.conv_1`` / ``conv_2`` are ``bottleneck_1`` /
    ``bottleneck_2`` here, every other name and layout is the port's."""
    state_dict = ckpt["model"] if "model" in ckpt else ckpt
    out = {}
    for key, value in state_dict.items():
        for i in (1, 2):
            if key.startswith(f"buttleneck.conv_{i}."):
                key = f"bottleneck_{i}." + key[len(f"buttleneck.conv_{i}."):]
        out[key] = torch.as_tensor(value).float()
    return out, dict(ckpt.get("param_dict", {}))


# ------------------------------------------------------------------ ResNet-50


def convert_resnet50_state_dict(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A torchvision resnet50 state_dict (fc replaced by a 24-output Linear,
    as the reference's court model) -> the port's ResNet50Regressor
    state_dict: ``layer{s}.{b}.`` is ``layer{s}_{b}.``, each ``bn{k}`` joins
    ``conv{k}`` in one ConvBN, ``downsample.0`` / ``.1`` are
    ``down_conv.conv`` / ``down_conv.bn``. No transposes."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0].startswith("layer") and len(parts) > 2 and parts[1].isdigit():
            parts = [f"{parts[0]}_{parts[1]}"] + parts[2:]
        if "downsample" in parts:
            i = parts.index("downsample")
            parts[i: i + 2] = ["down_conv", {"0": "conv", "1": "bn"}[parts[i + 1]]]
        elif parts[0] != "fc":
            mod = parts[-2]
            if mod.startswith("bn"):
                parts[-2:-1] = [f"conv{mod[2:]}", "bn"]
            elif mod.startswith("conv"):
                parts[-2:-1] = [mod, "conv"]
            else:
                raise ValueError(f"not a torchvision resnet50 key: {key!r}")
        value = torch.as_tensor(value)
        out[".".join(parts)] = value.float() if value.is_floating_point() else value
    return out


# ------------------------------------------------------------------- YOLOv8

# ultralytics DetectionModel/PoseModel layer indices -> the port's names
# (the layers between carry no parameters: Upsample, Concat).
_YOLO_LAYERS = {
    "0": "stem", "1": "down1", "2": "c2f_1", "3": "down2", "4": "c2f_2",
    "5": "down3", "6": "c2f_3", "7": "down4", "8": "c2f_4", "9": "sppf",
    "12": "neck_c2f_1", "15": "neck_c2f_2", "16": "neck_down1",
    "18": "neck_c2f_3", "19": "neck_down2", "21": "neck_c2f_4",
}
_HEAD_BRANCH = {"cv2": "box", "cv3": "cls", "cv4": "kpt"}
_HEAD_LAYER = {"0": "c0", "1": "c1", "2": "proj"}


def _yolo_key(key: str, head_index: str) -> str:
    parts = key.split(".")
    if parts[0] != "model" or len(parts) < 3:
        raise ValueError(f"not an ultralytics YOLOv8 key: {key!r}")
    idx, rest = parts[1], parts[2:]
    if idx == head_index:
        branch, scale, layer, *leaf = rest
        return ".".join([f"{_HEAD_BRANCH[branch]}_{scale}", _HEAD_LAYER[layer], *leaf])
    if idx not in _YOLO_LAYERS:
        raise ValueError(f"unhandled ultralytics layer in {key!r}")
    # C2f bottlenecks are 'm.{i}' there and 'm_{i}' here.
    for i, p in enumerate(rest[:-1]):
        if p == "m" and rest[i + 1].isdigit():
            rest = rest[:i] + [f"m_{rest[i + 1]}"] + rest[i + 2:]
            break
    return ".".join([_YOLO_LAYERS[idx], *rest])


def yolov8_state_dict_from_ultralytics(state_dict: Mapping[str, Any],
                                       head_index: int = 22) -> dict[str, torch.Tensor]:
    """ultralytics YOLOv8 detect/pose state_dict -> the port's YOLOv8
    state_dict (fp32). The DFL conv (a frozen arange) is dropped: the decode
    takes the expectation in closed form."""
    out = {}
    for key, value in state_dict.items():
        if ".dfl." in key:
            continue
        if key.startswith("model.model."):
            key = key[len("model."):]
        value = torch.as_tensor(value)
        out[_yolo_key(key, str(head_index))] = (
            value.float() if value.is_floating_point() else value)
    return out


def load_torch_checkpoint(path: str, allow_pickle: bool = False):
    """torch.load a .pt checkpoint, safest path first.

    Tries ``weights_only=True`` (no code runs) first; TrackNet's dict
    checkpoints need nothing more. ultralytics .pt files pickle whole
    nn.Module objects, so they need a full unpickle, which runs code from
    the file: only with ``allow_pickle=True``, and with stub ultralytics
    modules, so that the ultralytics package need not be installed."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
    return _load_torch_checkpoint_unpickle(path)


_ULTRALYTICS_MODULES = (
    "ultralytics",
    "ultralytics.nn",
    "ultralytics.nn.tasks",
    "ultralytics.nn.modules",
    "ultralytics.nn.modules.block",
    "ultralytics.nn.modules.conv",
    "ultralytics.nn.modules.head",
    "ultralytics.utils",
    "ultralytics.utils.loss",
    "ultralytics.utils.tal",
)


def _load_torch_checkpoint_unpickle(path: str):
    """Full torch.load with stub ultralytics modules: every class they are
    asked for is a bare nn.Module subclass, which restores the pickled
    parameters and buffers (all `state_dict` needs). The stubs are removed
    afterwards."""
    installed = []
    for name in _ULTRALYTICS_MODULES:
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__getattr__ = lambda attr, _n=name: type(attr, (torch.nn.Module,),
                                                         {"__module__": _n})
            sys.modules[name] = mod
            installed.append(name)
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        for name in installed:
            sys.modules.pop(name, None)
