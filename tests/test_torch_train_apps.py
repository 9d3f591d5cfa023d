"""The port's train apps and apps/evaluate end to end on the CPU
(--device cpu) on tiny datasets written to disk, and their checkpoints:

- train_tracknet -> the reference's {'model', 'param_dict'} .pt, which
  BallTracker(tracking_model_path=...) loads (its TrackNet's weights are
  the file's);
- train_inpaintnet (--synthetic-gaps) -> the reference's InpaintNet .pt
  (`buttleneck.conv_k` names), which BallTrackerConfig(inpainting_model_
  path=...) loads;
- train_yolo detect and pose (13 keypoints) -> ultralytics-named .pt files
  that PlayerTracker and PlayerKeypointsTracker load; apps/evaluate scores
  the pose file and prints its one JSON line;
- train_court (ResNet-50) -> torchvision-named .pt that the resnet court
  KeypointsTracker loads;
- images decode with Pillow where OpenCV is absent;
- --resume reads each file back (with --epochs 0 the written weights equal
  the read ones); --out / --resume take the JAX apps' .msgpack too (the JAX
  package's load_variables reads what is written); --model-parallel 2 and
  --data-parallel 2 without a process group raise ValueError (the model
  axis on gloo ranks: tests/test_torch_tensor_parallel_apps.py); with no
  --device the apps take cuda, and raise where there is no card (no CPU
  fallback).
"""

import csv
import json

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu_torch.apps import (
    evaluate,
    train_court,
    train_inpaintnet,
    train_tracknet,
    train_yolo,
)
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.trackers import (
    BallTracker,
    KeypointsTracker,
    PlayerKeypointsTracker,
    PlayerTracker,
)
from padel_analytics_tpu_torch.training.checkpoint import load_for_resume

RID = "1_00_01"


@pytest.fixture(scope="module")
def rally(tmp_path_factory):
    root = tmp_path_factory.mktemp("match")
    fd = root / "frame" / RID
    fd.mkdir(parents=True)
    (root / "csv").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(14):
        img = rng.integers(55, 65, (90, 160, 3), dtype=np.uint8)
        x, y = 10 + i * 9, 40 + int(6 * np.sin(i))
        visible = i % 5 != 4
        if visible:
            img[y - 2: y + 3, x - 2: x + 3] = (250, 250, 120)
        Image.fromarray(img).save(fd / f"{i}.png")
        rows.append({"Frame": i, "X": x if visible else 0, "Y": y if visible else 0,
                     "Visibility": int(visible)})
    with open(root / "csv" / f"{RID}_ball.csv", "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=["Frame", "X", "Y", "Visibility"])
        wtr.writeheader()
        wtr.writerows(rows)
    return root


@pytest.fixture(scope="module")
def yolo_data(tmp_path_factory):
    """4 images with one box and 13 keypoints each (ultralytics layout)."""
    root = tmp_path_factory.mktemp("yolo")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(1)
    for i in range(4):
        img = rng.integers(20, 50, (80, 96, 3), dtype=np.uint8)
        img[20:60, 20:60] = 220
        Image.fromarray(img).save(root / "images" / f"im{i}.png")
        kp = " ".join(f"{0.25 + 0.02 * k:.3f} {0.3 + 0.03 * k:.3f} 2" for k in range(13))
        (root / "labels" / f"im{i}.txt").write_text(f"0 0.42 0.5 0.42 0.5 {kp}\n")
    return root


def _equal_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _ball_args(rally, out, *extra):
    return ["--match-dir", str(rally), "--rallies", RID, "--epochs", "1", "--batch", "2",
            "--seq-len", "4", "--height", "32", "--width", "64", "--device", "cpu",
            "--out", str(out), *extra]


def test_train_tracknet_app(rally, tmp_path):
    out = tmp_path / "tn.pt"
    assert train_tracknet.main(_ball_args(rally, out, "--mixup", "0.5")) == 0
    ckpt = torch.load(out, weights_only=True)
    assert ckpt["param_dict"]["seq_len"] == 4 and ckpt["param_dict"]["bg_mode"] == "concat"
    ball = BallTracker(str(out), config=BallTrackerConfig(seq_len=4, height=32, width=64),
                       device="cpu")
    _equal_state(ball.tracknet.model.state_dict(), ckpt["model"])
    again = tmp_path / "again.pt"
    assert train_tracknet.main(_ball_args(rally, again, "--resume", str(out),
                                          "--epochs", "0")) == 0
    _equal_state(load_for_resume("tracknet", again), load_for_resume("tracknet", out))


def test_train_inpaintnet_app(rally, tmp_path):
    out = tmp_path / "inp.pt"
    args = ["--match-dir", str(rally), "--rallies", RID, "--epochs", "2", "--batch", "2",
            "--seq-len", "4", "--synthetic-gaps", "--img-wh", "160", "90", "--device", "cpu"]
    assert train_inpaintnet.main(args + ["--out", str(out)]) == 0
    ckpt = torch.load(out, weights_only=True)
    assert {"buttleneck.conv_1.conv.weight", "buttleneck.conv_2.conv.bias"} <= set(ckpt["model"])
    ball = BallTracker(None, config=BallTrackerConfig(inpainting_model_path=str(out)),
                       device="cpu")
    _equal_state(ball.inpaintnet.model.state_dict(), load_for_resume("inpaintnet", out))
    again = tmp_path / "again.pt"
    assert train_inpaintnet.main(args + ["--out", str(again), "--resume", str(out),
                                         "--epochs", "0"]) == 0
    _equal_state(load_for_resume("inpaintnet", again), load_for_resume("inpaintnet", out))


@pytest.mark.parametrize("nk", [0, 13], ids=["det", "pose"])
def test_train_yolo_app_and_evaluate(yolo_data, tmp_path, capsys, nk):
    out = tmp_path / "yolo.pt"
    args = ["--images", str(yolo_data / "images"), "--labels", str(yolo_data / "labels"),
            "--imgsz", "64", "--variant", "n", "--batch", "8", "--max-gt", "4",
            "--keypoints", str(nk), "--device", "cpu"]
    assert train_yolo.main(args + ["--epochs", "2", "--out", str(out)]) == 0
    sd = torch.load(out, weights_only=True)
    assert "model.22.cv2.0.0.conv.weight" in sd and "model.22.dfl.conv.weight" in sd
    if nk:
        tracker = PlayerKeypointsTracker(str(out), model_variant="n", device="cpu")
    else:
        tracker = PlayerTracker(str(out), None, model_variant="n", device="cpu")
    _equal_state(tracker.engine.model.state_dict(), load_for_resume("yolo", out))
    again = tmp_path / "again.pt"
    assert train_yolo.main(args + ["--epochs", "0", "--out", str(again),
                                   "--resume", str(out)]) == 0
    _equal_state(load_for_resume("yolo", again), load_for_resume("yolo", out))

    capsys.readouterr()
    assert evaluate.main(["--images", str(yolo_data / "images"), "--labels",
                          str(yolo_data / "labels"), "--weights", str(out), "--variant", "n",
                          "--imgsz", "64", "--keypoints", str(nk), "--conf", "0.0",
                          "--batch", "3", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["images"] == 4 and 0.0 <= rec["map"] <= 1.0 and 0.0 <= rec["map50"] <= 1.0
    assert ("mean_oks" in rec) == bool(nk)


def test_train_court_app(tmp_path):
    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    rng = np.random.default_rng(3)
    kps = [[10.0 + 5 * k, 50.0 - 3 * k] for k in range(12)]
    for i in range(3):
        Image.fromarray(rng.integers(20, 60, (60, 80, 3), dtype=np.uint8)).save(
            img_dir / f"f{i}.png")
    (tmp_path / "kp.json").write_text(json.dumps({f"f{i}.png": kps for i in range(3)}))
    out = tmp_path / "court.pt"
    # batch 8 > 3 images: the batch clamps to the dataset (else zero steps)
    args = ["--images", str(img_dir), "--keypoints", str(tmp_path / "kp.json"), "--imgsz", "32",
            "--batch", "8", "--device", "cpu"]
    assert train_court.main(args + ["--epochs", "1", "--out", str(out)]) == 0
    sd = torch.load(out, weights_only=True)
    assert {"conv1.weight", "bn1.running_var", "layer4.0.downsample.1.weight",
            "fc.bias"} <= set(sd)
    court = KeypointsTracker(str(out), model_type="resnet", device="cpu")
    _equal_state(court.engine.model.state_dict(), load_for_resume("resnet", out))
    again = tmp_path / "again.pt"
    assert train_court.main(args + ["--epochs", "0", "--out", str(again),
                                    "--resume", str(out)]) == 0
    _equal_state(load_for_resume("resnet", again), load_for_resume("resnet", out))


def test_images_decode_without_opencv(rally, monkeypatch):
    """Where OpenCV does not import, the loaders decode with Pillow: the
    same pixels (PNG is lossless)."""
    from padel_analytics_tpu_torch.training.data import imread_rgb

    path = rally / "frame" / RID / "3.png"
    want = imread_rgb(path)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    np.testing.assert_array_equal(imread_rgb(path), want)
    with pytest.raises(FileNotFoundError):
        imread_rgb(rally / "missing.png")


def test_msgpack_resume_refused(rally, tmp_path):
    """--out .msgpack writes the JAX package's Flax tree, which its
    _engine.load_variables reads and --resume reads back; a .msgpack that
    is missing, or a suffix the loaders do not know, is refused (no random
    weights)."""
    import jax.numpy as jnp
    from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
    from padel_analytics_tpu.trackers import _engine

    from padel_analytics_tpu_torch.models.convert import state_dict_from_flax

    out = tmp_path / "tn.msgpack"
    assert train_tracknet.main(_ball_args(rally, out)) == 0
    model, in_dim = jax_make_tracknet(4, "concat")
    variables = _engine.load_variables(model, jnp.zeros((1, 32, 64, in_dim)), str(out))
    resumed = load_for_resume("tracknet", out)
    sd = state_dict_from_flax({k: dict(v) for k, v in variables.items()})
    _equal_state({k: v for k, v in resumed.items() if "num_batches" not in k},
                 {k: v for k, v in sd.items() if "num_batches" not in k})
    again = tmp_path / "again.pt"
    assert train_tracknet.main(_ball_args(rally, again, "--resume", str(out),
                                          "--epochs", "0")) == 0
    _equal_state({k: v for k, v in load_for_resume("tracknet", again).items()
                  if "num_batches" not in k},
                 {k: v for k, v in resumed.items() if "num_batches" not in k})
    with pytest.raises(FileNotFoundError):
        train_tracknet.main(_ball_args(rally, tmp_path / "x.pt", "--resume",
                                       str(tmp_path / "missing.msgpack")))
    with pytest.raises(ValueError, match="msgpack"):
        train_tracknet.main(_ball_args(rally, tmp_path / "x.pt", "--resume",
                                       str(tmp_path / "tracknet.ckpt")))


def test_model_parallel_and_data_parallel_refused(rally, tmp_path):
    with pytest.raises(ValueError, match="--model-parallel 2 needs that many processes"):
        train_tracknet.main(_ball_args(rally, tmp_path / "x.pt", "--model-parallel", "2"))
    with pytest.raises(ValueError, match="--data-parallel 2"):
        train_tracknet.main(_ball_args(rally, tmp_path / "x.pt", "--data-parallel", "2"))


#: Each app's required flags, with values never read (the device comes first).
REQUIRED = {
    train_tracknet: ["--match-dir", "m", "--rallies", "r"],
    train_inpaintnet: ["--match-dir", "m", "--rallies", "r"],
    train_court: ["--images", "i", "--keypoints", "k.json"],
    train_yolo: ["--images", "i", "--labels", "l"],
    evaluate: ["--images", "i", "--labels", "l", "--weights", "w.pt"],
}


@pytest.mark.parametrize("app", list(REQUIRED), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_apps_default_to_cuda(app):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(REQUIRED[app])
