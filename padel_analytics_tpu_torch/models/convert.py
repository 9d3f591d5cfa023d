"""Weights carried into the port's torch modules.

Counterpart of ``padel_analytics_tpu/models/convert.py``, in the other
direction where the source is the JAX package: `state_dict_from_flax` maps
a ``{'params', 'batch_stats'}`` variable tree (as numpy arrays) onto a torch
``state_dict``, and `flax_from_state_dict` maps it back (the .msgpack files
and orbax directories that `load_flax_state_dict` reads and `save_flax`
writes, with core/checkpoint.py). The port's submodule names equal the Flax tree's (TrackNet,
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
            out[f"{module}.{name}"] = torch.from_numpy(np.array(value, np.float32))
        else:
            raise ValueError(f"unhandled parameter {'/'.join(path)}")
    for path, value in _walk(variables.get("batch_stats", {})):
        module, leaf = module_name(path[:-1]), path[-1]
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unhandled batch stat {'/'.join(path)}")
        out[f"{module}.{names[leaf]}"] = torch.from_numpy(np.array(value, np.float32))
        out.setdefault(f"{module}.num_batches_tracked", torch.tensor(0))
    return out


#: The ball path's name for the bridge.
tracknet_state_dict_from_flax = state_dict_from_flax

#: Weight layout (torch) -> kernel layout (Flax): `_KERNEL_AXES` inverted.
_WEIGHT_AXES = {n: tuple(np.argsort(axes)) for n, axes in _KERNEL_AXES.items()}


def _flax_resnet_module(parts: list[str]) -> list[str]:
    """A port ResNet50Regressor module path -> the Flax one (the inverse of
    `_resnet_module`): ``convN.conv`` / ``convN.bn`` are ``convN`` / ``bnN``,
    ``down_conv.conv`` / ``.bn`` are ``down_conv`` / ``down_bn``."""
    if len(parts) >= 2 and parts[-1] in ("conv", "bn"):
        *parent, mod, sub = parts
        if mod == "down_conv":
            return [*parent, "down_conv" if sub == "conv" else "down_bn"]
        if mod.startswith("conv"):
            return [*parent, mod if sub == "conv" else f"bn{mod[4:]}"]
    return parts


def _put(tree: dict, path: list[str], value: np.ndarray) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    if path[-1] in tree:
        raise ValueError(f"two weights map to {'/'.join(path)}")
    tree[path[-1]] = value


def convert_state_dict(state_dict: Mapping[str, Any],
                       name_map: Mapping[str, tuple[str, ...]] | None = None) -> dict:
    """The JAX package's generic torch -> Flax conversion: a state_dict ->
    ``{'params', 'batch_stats'}`` of numpy leaves in their own dtype, dotted
    module paths as nested keys in the state_dict's order. `name_map`
    rewrites module-path prefixes (the longest that matches). A weight of
    rank 4 / 3 / 2 is a kernel (Conv2d OIHW -> HWIO, Conv1d OIK -> KIO,
    Linear OI -> IO), of rank 1 a BatchNorm scale; running statistics go to
    ``batch_stats``, which a model without BatchNorm does not get;
    ``num_batches_tracked`` (no Flax counterpart) is dropped."""
    prefixes = sorted(name_map or {}, key=len, reverse=True)
    params: dict = {}
    stats: dict = {}
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        for p in prefixes:
            if module == p or module.startswith(p + "."):
                module = ".".join(name_map[p]) + module[len(p):]
                break
        path = [m for m in module.split(".") if m]
        arr = torch.as_tensor(value).detach().cpu().numpy()
        if leaf == "weight" and arr.ndim in _WEIGHT_AXES:
            _put(params, [*path, "kernel"],
                 np.ascontiguousarray(arr.transpose(_WEIGHT_AXES[arr.ndim])))
        elif leaf == "weight" and arr.ndim == 1:
            _put(params, [*path, "scale"], arr.copy())
        elif leaf == "bias":
            _put(params, [*path, "bias"], arr.copy())
        elif leaf in ("running_mean", "running_var"):
            _put(stats, [*path, "mean" if leaf == "running_mean" else "var"], arr.copy())
        else:
            raise ValueError(f"unhandled weight {key} {tuple(arr.shape)}")
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def flax_from_state_dict(state_dict: Mapping[str, Any]) -> dict[str, dict]:
    """A port state_dict (TrackNet, YOLOv8, InpaintNet, ResNet50Regressor)
    -> the JAX package's ``{'params', 'batch_stats'}`` variable tree of the
    same model, float32 numpy leaves: the inverse of
    `state_dict_from_flax`, by `convert_state_dict`. Keys are sorted at
    every level, as in the trees JAX builds."""
    resnet = "fc.weight" in state_dict and "conv1.bn.weight" in state_dict
    renamed = {}
    for key, value in state_dict.items():
        *module, leaf = key.split(".")
        if resnet:
            module = _flax_resnet_module(module)
        renamed[".".join([*module, leaf])] = torch.as_tensor(value).float()
    return _sorted(convert_state_dict(renamed))


def _sorted(tree):
    """Keys sorted at every level, as JAX orders a dict it rebuilds (so the
    file's bytes are the JAX package's for the same weights)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def load_flax_state_dict(path) -> dict[str, torch.Tensor]:
    """A Flax .msgpack variable file or an orbax checkpoint directory (the
    JAX package's trackers and train apps) -> the port's state_dict of the
    same model."""
    from ..core.checkpoint import load_checkpoint

    return state_dict_from_flax(load_checkpoint(path))


def save_flax(path, model: torch.nn.Module) -> None:
    """Write a port model's weights as the JAX package's .msgpack file, or
    for any other path an orbax checkpoint directory (what its
    `_engine.load_variables` reads for the same model)."""
    from ..core.checkpoint import save_checkpoint

    save_checkpoint(flax_from_state_dict(model.state_dict()), path)


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


def _ultralytics_renamed(state_dict: Mapping[str, Any], head_index: int) -> dict:
    """An ultralytics YOLOv8 state_dict under the port's names, the DFL conv
    (a frozen arange) dropped: the decode takes the expectation in closed
    form."""
    out = {}
    for key, value in state_dict.items():
        if ".dfl." in key:
            continue
        if key.startswith("model.model."):
            key = key[len("model."):]
        out[_yolo_key(key, str(head_index))] = torch.as_tensor(value)
    return out


def yolov8_state_dict_from_ultralytics(state_dict: Mapping[str, Any],
                                       head_index: int = 22) -> dict[str, torch.Tensor]:
    """ultralytics YOLOv8 detect/pose state_dict -> the port's YOLOv8
    state_dict (fp32)."""
    return {k: v.float() if v.is_floating_point() else v
            for k, v in _ultralytics_renamed(state_dict, head_index).items()}


def yolo_name_map(head_index: int = 22) -> dict[str, tuple[str, ...]]:
    """The JAX package's prefix map of an ultralytics v8 state_dict
    (``model.{i}...`` -> the Flax module path), from the port's tables."""
    out = {f"model.{i}": (name,) for i, name in _YOLO_LAYERS.items()}
    for branch, ours in _HEAD_BRANCH.items():
        for scale in range(3):
            for layer, our_layer in _HEAD_LAYER.items():
                out[f"model.{head_index}.{branch}.{scale}.{layer}"] = (f"{ours}_{scale}",
                                                                        our_layer)
    return out


def convert_yolov8_state_dict(state_dict: Mapping[str, Any], head_index: int = 22) -> dict:
    """The JAX package's conversion of an ultralytics YOLOv8 detect/pose
    state_dict: its Flax variable tree, numpy leaves in the state_dict's
    dtypes (`convert_state_dict` of the port's names, which are the Flax
    tree's)."""
    return convert_state_dict(_ultralytics_renamed(state_dict, head_index))


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
