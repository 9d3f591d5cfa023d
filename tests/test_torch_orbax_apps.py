"""Every port loader and app that takes a weights path, given an orbax
checkpoint directory, on the CPU at small sizes: from a directory the JAX
package's `save_checkpoint` wrote (OCDBT, zstd) and from one the port wrote
(`models/convert.py::save_flax`, the plain layout), each gives the
state_dict that the .msgpack of the same weights gives:

- the trackers: BallTracker (TrackNet and InpaintNet; seq_len / bg_mode from
  the config, checked against the shapes), PlayerTracker, PlayerKeypointsTracker
  and both model courts (yolo, resnet);
- training/checkpoint.py::load_for_resume of each family;
- apps/convert_weights IN.pt OUT_DIR; apps/evaluate --weights DIR (the same
  JSON line as from the .msgpack);
- the four train apps' --resume DIR and --out DIR (--epochs 0: what is
  written is what was read);
- `checkpoint_format`, the one suffix rule every loader shares: a missing
  path raises FileNotFoundError, a file that is neither .pt / .pth /
  .msgpack nor a directory ValueError.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu.core import checkpoint as jax_checkpoint
from padel_analytics_tpu_torch.apps import (
    convert_weights,
    evaluate,
    train_court,
    train_inpaintnet,
    train_tracknet,
    train_yolo,
)
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.core.checkpoint import checkpoint_format
from padel_analytics_tpu_torch.models.convert import (
    flax_from_state_dict,
    load_flax_state_dict,
    save_flax,
)
from padel_analytics_tpu_torch.models.layers import lecun_normal_
from padel_analytics_tpu_torch.models.resnet import ResNet50Regressor
from padel_analytics_tpu_torch.models.tracknet import InpaintNet, make_tracknet
from padel_analytics_tpu_torch.models.yolov8 import YOLOv8
from padel_analytics_tpu_torch.trackers import (
    BallTracker,
    KeypointsTracker,
    PlayerKeypointsTracker,
    PlayerTracker,
)
from padel_analytics_tpu_torch.training import checkpoint as tckpt
from padel_analytics_tpu_torch.training.checkpoint import load_for_resume

from test_torch_train_apps import RID, _ball_args, rally, yolo_data  # noqa: F401  (fixtures)

#: kind -> (the port model, its load_for_resume family).
KINDS = {
    "tracknet": (lambda: make_tracknet(4, "concat")[0], "tracknet"),
    "inpaintnet": (InpaintNet, "inpaintnet"),
    "yolo_det": (lambda: YOLOv8("n", 1), "yolo"),
    "yolo_pose": (lambda: YOLOv8("n", 1, num_keypoints=13), "yolo"),
    "yolo_court": (lambda: YOLOv8("n", 1, num_keypoints=12), "yolo"),
    "resnet": (ResNet50Regressor, "resnet"),
    "resnet_small": (lambda: ResNet50Regressor(stage_sizes=(1, 1, 1, 1)), "resnet"),
}
SOURCES = ["jax", "port"]


def _seeded(model, seed):
    lecun_normal_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for key, value in model.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                value.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed))
    return model.eval()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """kind -> {"model", "msgpack", "jax" (the JAX package's orbax
    directory), "port" (the port's)} of one seeded model."""
    root = tmp_path_factory.mktemp("weights")
    out = {}
    for i, (kind, (make, _)) in enumerate(KINDS.items()):
        model = _seeded(make(), 40 + i)
        paths = {"model": model, "msgpack": root / f"{kind}.msgpack",
                 "jax": root / f"{kind}_jax", "port": root / f"{kind}_port"}
        save_flax(paths["msgpack"], model)
        jax_checkpoint.save_checkpoint(flax_from_state_dict(model.state_dict()),
                                       str(paths["jax"]))
        save_flax(paths["port"], model)
        out[kind] = paths
    return out


def _equal_state(a: dict, b: dict):
    a = {k: v for k, v in a.items() if not k.endswith("num_batches_tracked")}
    b = {k: v for k, v in b.items() if not k.endswith("num_batches_tracked")}
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ----------------------------------------------------------------- loaders


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("kind", [k for k in KINDS if k != "resnet"])  # the court test reads it
def test_load_for_resume_from_directory(weights, kind, src):
    w = weights[kind]
    assert checkpoint_format(w[src]) == "orbax" and checkpoint_format(w["msgpack"]) == "flax"
    family = KINDS[kind][1]
    want = load_for_resume(family, w["msgpack"])
    _equal_state(load_for_resume(family, w[src]), want)
    _equal_state(want, w["model"].state_dict())


@pytest.mark.parametrize("src", SOURCES)
def test_ball_tracker_from_directories(weights, src):
    cfg = BallTrackerConfig(seq_len=4, height=32, width=64)
    a, b = (BallTracker(str(weights["tracknet"][s]), str(weights["inpaintnet"][s]), config=cfg,
                        compute_dtype=torch.float32, device="cpu") for s in ("msgpack", src))
    _equal_state(b.tracknet.model.state_dict(), a.tracknet.model.state_dict())
    _equal_state(b.inpaintnet.model.state_dict(), a.inpaintnet.model.state_dict())
    assert (b.tracknet_seq_len, b.bg_mode, b.inpaintnet_seq_len) == (4, "concat", 16)
    with pytest.raises(ValueError, match="seq_len=8"):
        BallTracker(str(weights["tracknet"][src]), config=BallTrackerConfig(seq_len=8),
                    device="cpu")


@pytest.mark.parametrize("src", SOURCES)
def test_players_and_pose_from_directories(weights, src):
    for kind, make in (
            ("yolo_det", lambda p: PlayerTracker(p, None, model_variant="n", device="cpu")),
            ("yolo_pose", lambda p: PlayerKeypointsTracker(p, model_variant="n",
                                                           device="cpu"))):
        a, b = (make(str(weights[kind][s])) for s in ("msgpack", src))
        _equal_state(b.engine.model.state_dict(), a.engine.model.state_dict())


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("mode", ["yolo", "resnet"])
def test_courts_from_directories(weights, mode, src):
    kind = "yolo_court" if mode == "yolo" else "resnet"
    a, b = (KeypointsTracker(str(weights[kind][s]), model_type=mode, model_variant="n",
                             device="cpu") for s in ("msgpack", src))
    _equal_state(b.engine.model.state_dict(), a.engine.model.state_dict())


def test_checkpoint_format_rule(weights, tmp_path):
    """One rule for every loader: .pt / .pth torch, .msgpack Flax, a
    directory orbax; a missing path or any other file raises."""
    pt = tmp_path / "w.pt"
    tckpt.save_yolov8(pt, weights["yolo_det"]["model"])
    assert [checkpoint_format(p) for p in (pt, weights["yolo_det"]["msgpack"],
                                            weights["yolo_det"]["jax"])] == \
        ["torch", "flax", "orbax"]
    with pytest.raises(FileNotFoundError, match="YOLOv8 checkpoint"):
        PlayerTracker(str(tmp_path / "missing"), None, model_variant="n", device="cpu")
    (tmp_path / "weights.bin").write_bytes(b"\0")
    for load in (lambda p: PlayerTracker(p, None, model_variant="n", device="cpu"),
                 lambda p: BallTracker(p, device="cpu"),
                 lambda p: KeypointsTracker(p, model_type="resnet", device="cpu"),
                 lambda p: load_for_resume("inpaintnet", p)):
        with pytest.raises(ValueError, match="orbax checkpoint directory"):
            load(str(tmp_path / "weights.bin"))
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        load_for_resume("yolo", tmp_path)


# -------------------------------------------------------------------- apps


def test_convert_weights_writes_directories(weights, tmp_path):
    """convert_weights IN.pt OUT_DIR: the state_dict of OUT.msgpack's; a
    second run onto the same OUT raises, as orbax does."""
    cases = {"inpaintnet": (["inpaintnet"], tckpt.save_inpaintnet),
             "yolo_pose": (["yolo", "--variant", "n", "--keypoints", "13"], tckpt.save_yolov8)}
    for kind, (argv, save) in cases.items():
        pt = tmp_path / f"{kind}.pt"
        save(pt, weights[kind]["model"])
        outs = {}
        for name in (f"{kind}.msgpack", f"{kind}_dir"):
            assert convert_weights.main([argv[0], str(pt), str(tmp_path / name),
                                         *argv[1:]]) == 0
            outs[name] = load_flax_state_dict(tmp_path / name)
        _equal_state(outs[f"{kind}_dir"], outs[f"{kind}.msgpack"])
        _equal_state(outs[f"{kind}_dir"], load_flax_state_dict(weights[kind]["jax"]))
    with pytest.raises(ValueError, match="already exists"):
        convert_weights.main(["inpaintnet", str(tmp_path / "inpaintnet.pt"),
                              str(tmp_path / "inpaintnet_dir")])


def test_evaluate_weights_directory(weights, yolo_data, capsys):  # noqa: F811
    lines = []
    for s in ("msgpack", *SOURCES):
        capsys.readouterr()
        assert evaluate.main(["--images", str(yolo_data / "images"), "--labels",
                              str(yolo_data / "labels"), "--weights",
                              str(weights["yolo_pose"][s]), "--variant", "n", "--imgsz", "64",
                              "--keypoints", "13", "--conf", "0.0", "--batch", "4",
                              "--device", "cpu"]) == 0
        lines.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert lines[0] == lines[1] == lines[2] and lines[0]["images"] == 4


def _court_data(root):
    img_dir = root / "frames"
    img_dir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        Image.fromarray(rng.integers(20, 60, (60, 80, 3), dtype=np.uint8)).save(
            img_dir / f"f{i}.png")
    kps = [[10.0 + 5 * k, 50.0 - 3 * k] for k in range(12)]
    (root / "kp.json").write_text(json.dumps({f"f{i}.png": kps for i in range(2)}))
    return ["--images", str(img_dir), "--keypoints", str(root / "kp.json"), "--imgsz", "32",
            "--batch", "2", "--stage-sizes", "1,1,1,1", "--device", "cpu"]


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("app", ["tracknet", "inpaintnet", "yolo", "court"])
def test_train_apps_resume_and_out_directories(weights, rally, yolo_data, tmp_path,  # noqa: F811
                                               app, src):
    """--resume DIR --epochs 0 --out DIR: the written directory holds what
    the directory read held, which is the .msgpack's state_dict."""
    out = tmp_path / "out"
    if app == "tracknet":
        kind = "tracknet"
        argv = _ball_args(rally, out, "--epochs", "0")
        main = train_tracknet.main
    elif app == "inpaintnet":
        kind = "inpaintnet"
        argv = ["--match-dir", str(rally), "--rallies", RID, "--epochs", "0", "--batch", "2",
                "--seq-len", "4", "--synthetic-gaps", "--img-wh", "160", "90", "--device", "cpu",
                "--out", str(out)]
        main = train_inpaintnet.main
    elif app == "yolo":
        kind = "yolo_det"
        argv = ["--images", str(yolo_data / "images"), "--labels", str(yolo_data / "labels"),
                "--imgsz", "64", "--variant", "n", "--batch", "4", "--max-gt", "4",
                "--epochs", "0", "--device", "cpu", "--out", str(out)]
        main = train_yolo.main
    else:
        kind = "resnet_small"
        argv = _court_data(tmp_path) + ["--epochs", "0", "--out", str(out)]
        main = train_court.main
    assert main(argv + ["--resume", str(weights[kind][src])]) == 0
    family = KINDS[kind][1]
    assert checkpoint_format(out) == "orbax"
    _equal_state(load_for_resume(family, out), load_for_resume(family, weights[kind]["msgpack"]))
