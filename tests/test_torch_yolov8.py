"""Port YOLOv8 (detect and pose) and its weight loaders against the JAX
package and an ultralytics-named torch twin.

- The JAX YOLOv8's random variable tree (BatchNorm statistics not the
  identity), bridged by state_dict_from_flax, runs in the port at fp32 to
  the JAX model's boxes, scores, keypoints and raw head outputs within
  1e-4 of each output's largest magnitude (fp32 summation order through ~70
  convs; measured <= 7e-6).
- The ultralytics-named twin of tests/test_yolo_convert_twin.py, renamed by
  yolov8_state_dict_from_ultralytics, gives the twin's own forward plus the
  ultralytics decode within the same bound; a pickled ultralytics-style
  checkpoint loads through the stub unpickler only when pickles are allowed.
"""

import importlib.util
import pickle
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from padel_analytics_tpu.models import yolov8 as jyolo
from padel_analytics_tpu_torch.models import convert, yolov8
from padel_analytics_tpu_torch.models.layers import lecun_normal_
from padel_analytics_tpu_torch.trackers import PlayerKeypointsTracker, PlayerTracker
from _torch_helpers import random_jax_yolov8
from test_yolo_convert_twin import (
    TBottleneck,
    TC2f,
    TConv,
    THead,
    TSPPF,
    build_torch_yolov8n,
    decode_reference,
    run_torch_yolov8,
)

REL_TOL = 1e-4


def _close(got, want, name):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= REL_TOL * scale + 1e-6, f"{name}: max err {err} at scale {scale}"


@pytest.mark.parametrize("nc,nk", [(1, 0), (80, 0), (1, 13)])
def test_yolov8_matches_jax_fp32(rng, nc, nk):
    model, variables = random_jax_yolov8(rng, "n", nc, nk)
    x = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    want = {k: np.asarray(v) for k, v in model.apply(variables, jnp.asarray(x), raw=True).items()}

    port = yolov8.YOLOv8("n", nc, nk)
    port.load_state_dict(convert.state_dict_from_flax(variables))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in port.eval()(torch.from_numpy(x), raw=True).items()}
    assert set(got) == set(want)
    assert got["boxes"].shape == (2, yolov8.num_anchors(64, 96), 4)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        _close(got[k], want[k], k)


@pytest.mark.parametrize("variant,nk,fused", [("m", 0, 52), ("m", 13, 58), ("n", 13, 38)])
def test_k1_call_sites_and_flax_names(rng, variant, nk, fused):
    """Every stride-1 3x3 ConvBN is a K1 call site (52 in YOLOv8m detect, 58
    with the pose head); the state_dict's names are the Flax tree's."""
    port = yolov8.YOLOv8(variant, 1, nk)
    assert sum(getattr(m, "fused", False) for m in port.modules()) == fused
    if variant == "n":
        _, variables = random_jax_yolov8(rng, "n", 1, nk)
        sd = convert.state_dict_from_flax(variables)
        assert set(sd) == set(port.state_dict())
        assert {"c2f_1.m_0.cv1.conv.weight", "box_0.proj.bias", "kpt_2.c1.bn.running_var",
                "sppf.cv2.bn.weight"} <= set(sd)


def test_anchor_tables_match_jax():
    assert yolov8.num_anchors(384, 640) == jyolo.num_anchors(384, 640) == 5040
    for got, want in zip(yolov8.anchor_table(64, 96), jyolo.anchor_table(64, 96)):
        np.testing.assert_array_equal(got, want)


def test_scaling_rules_match_jax():
    for v, (d, w, m) in yolov8.YOLOV8_VARIANTS.items():
        assert jyolo.YOLOV8_VARIANTS[v] == (d, w, m)
        for c in (64, 128, 256, 512, 1024):
            assert yolov8._scale_ch(c, w, m) == jyolo._scale_ch(c, w, m)
        for n in (3, 6):
            assert yolov8._scale_d(n, d) == jyolo._scale_d(n, d)


@pytest.mark.parametrize("nc,nk", [(1, 0), (80, 0), (1, 13)])
def test_ultralytics_twin_forward(nc, nk):
    tm = build_torch_yolov8n(nc=nc, nk=nk, seed=7 + nc + nk)
    sd = convert.yolov8_state_dict_from_ultralytics(tm.state_dict())
    assert not any("dfl" in k for k in sd)
    port = yolov8.YOLOv8("n", nc, nk)
    port.load_state_dict(sd)
    x = np.random.default_rng(nc + nk).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        ref = decode_reference(*run_torch_yolov8(tm, torch.from_numpy(x)))
        out = port.eval()(torch.from_numpy(x.transpose(0, 2, 3, 1)))
    _close(out["boxes"].numpy(), ref[0], "boxes")
    _close(out["scores"].numpy(), ref[1], "scores")
    if nk:
        _close(out["kpts"].numpy(), ref[2], "kpts")


# The twin's classes under the names an ultralytics checkpoint pickles.
_ULTRALYTICS_NAMES = {
    TConv: ("ultralytics.nn.modules.conv", "Conv"),
    TBottleneck: ("ultralytics.nn.modules.block", "Bottleneck"),
    TC2f: ("ultralytics.nn.modules.block", "C2f"),
    TSPPF: ("ultralytics.nn.modules.block", "SPPF"),
    THead: ("ultralytics.nn.modules.head", "Pose"),
}
_ULTRALYTICS_ROOT = ("ultralytics.nn.tasks", "PoseModel")


def _save_ultralytics_style(tm, path, monkeypatch):
    """torch.save {'model': the twin in half precision} with every twin
    class re-badged as its ultralytics class, in stand-in modules that are
    gone again before the file is loaded."""
    classes = {}
    with monkeypatch.context() as m:
        for twin, (mod_name, name) in [*_ULTRALYTICS_NAMES.items(), (nn.Module, _ULTRALYTICS_ROOT)]:
            parts = mod_name.split(".")
            for i in range(1, len(parts) + 1):
                if ".".join(parts[:i]) not in sys.modules:
                    m.setitem(sys.modules, ".".join(parts[:i]),
                              types.ModuleType(".".join(parts[:i])))
            cls = type(name, (twin,), {"__module__": mod_name})
            setattr(sys.modules[mod_name], name, cls)
            classes[twin] = cls
        for mod in tm.modules():
            if type(mod) in _ULTRALYTICS_NAMES:
                mod.__class__ = classes[type(mod)]
        tm.__class__ = classes[nn.Module]
        torch.save({"model": tm.half(), "epoch": -1}, path)
    assert "ultralytics" not in sys.modules


def test_pickled_ultralytics_checkpoint_loads(tmp_path, monkeypatch):
    tm = build_torch_yolov8n(nc=1, nk=13, seed=3)
    want = {k: v.half().float() if v.is_floating_point() else v for k, v in
            convert.yolov8_state_dict_from_ultralytics(tm.state_dict()).items()}
    path = tmp_path / "yolov8n-pose.pt"
    _save_ultralytics_style(tm, path, monkeypatch)

    with pytest.raises(pickle.UnpicklingError):
        convert.load_torch_checkpoint(str(path))  # weights_only refuses the modules
    assert "ultralytics" not in sys.modules
    ckpt = convert.load_torch_checkpoint(str(path), allow_pickle=True)
    assert type(ckpt["model"]).__module__ == "ultralytics.nn.tasks"
    assert "ultralytics" not in sys.modules  # the stubs are removed again

    tracker = PlayerKeypointsTracker(str(path), train_image_size=64, model_variant="n",
                                     compute_dtype=torch.float32, device="cpu")
    got = tracker.engine.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_num_classes_inferred_from_checkpoint(tmp_path):
    tm = build_torch_yolov8n(nc=80, seed=5)
    path = tmp_path / "coco80.pt"
    torch.save(tm.state_dict(), path)
    tracker = PlayerTracker(str(path), None, model_variant="n", compute_dtype=torch.float32,
                            device="cpu")
    assert tracker.num_classes == 80
    with pytest.raises(ValueError, match="num_classes"):
        PlayerTracker(str(path), None, model_variant="n", num_classes=3, device="cpu")
    with pytest.raises(FileNotFoundError):
        PlayerTracker(str(tmp_path / "missing.pt"), None, model_variant="n", device="cpu")
    with pytest.raises(ValueError, match=".pt"):
        PlayerTracker(str(tmp_path / "weights.msgpack"), None, device="cpu")


def test_random_init_is_seeded():
    a, b = yolov8.YOLOv8("n", 1, 13), yolov8.YOLOv8("n", 1, 13)
    lecun_normal_(a, torch.Generator().manual_seed(3))
    lecun_normal_(b, torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("nk,hw,n,distinct", [(0, (384, 640), 52, 14), (13, (1280, 1280), 58, 20)])
def test_chip_smoke_k1_shapes_follow_the_model(nk, hw, n, distinct):
    """chip_smoke.py times K1 at the shapes the model itself launches, in
    call order (traced on the meta device, nothing computed)."""
    shapes = _chip_smoke().k1_call_shapes(yolov8.YOLOv8("m", 1, nk), *hw)
    assert len(shapes) == n and len(set(shapes)) == distinct
    h, w = hw
    assert shapes[0] == (48, 48, h // 4, w // 4)
    if nk:
        assert (576, 48, h // 32, w // 32) in shapes and (48, 48, h // 8, w // 8) in shapes
