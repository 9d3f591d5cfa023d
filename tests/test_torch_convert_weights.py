"""The port's apps/convert_weights against the JAX package's on the same
synthetic reference-format .pt files (seeded port models written by
training/checkpoint.py's save_*, the formats the reference's loaders read,
and an ultralytics-style pickled module), and the port's trackers served
from the .msgpack it writes:

- all four kinds (TrackNet {'model', 'param_dict'}, InpaintNet with the
  reference's `buttleneck` names, a torchvision resnet50 state_dict, YOLOv8
  under ultralytics names with 0 / 13 / 12 keypoints, and a stock-COCO
  80-class detector whose class count is inferred): the two .msgpack files
  are byte-equal (so they restore to equal trees), and the port's reader
  gives Flax's tree;
- a --classes that disagrees with the checkpoint exits (SystemExit), as in
  the JAX app;
- each port tracker (players, pose, ball with InpaintNet, the yolo and
  resnet courts) loaded from the .msgpack holds the .pt's weights exactly
  and gives the same outputs on the CPU at a small size;
- a TrackNet .msgpack whose shapes contradict the configured seq_len /
  bg_mode, a missing .msgpack and a malformed one raise (no random
  weights).
"""

import sys
import types

import flax.serialization as fser
import numpy as np
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu.apps import convert_weights as jax_convert
from padel_analytics_tpu_torch.apps import convert_weights
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.core.checkpoint import msgpack_restore
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
from padel_analytics_tpu_torch.utils.video import VideoInfo

from test_torch_flax_msgpack import assert_trees_equal


def seeded(model, seed):
    lecun_normal_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for key, value in model.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                value.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed))
    return model.eval()


def save_ultralytics_module(path, model):
    """A whole-module ultralytics-style .pt: a pickled module tree whose
    classes claim ultralytics.nn.tasks, under ultralytics' names, so only
    a full unpickle (with stub modules) reads it, as a real ultralytics
    checkpoint."""
    names = ("ultralytics", "ultralytics.nn", "ultralytics.nn.tasks")
    created = [n for n in names if n not in sys.modules]
    for n in created:
        sys.modules[n] = types.ModuleType(n)
    cls = type("DetectionModel", (torch.nn.Module,), {"__module__": "ultralytics.nn.tasks"})
    sys.modules["ultralytics.nn.tasks"].DetectionModel = cls
    try:
        root = cls()
        for key, value in tckpt.yolov8_ultralytics_state_dict(model.state_dict()).items():
            *parents, leaf = key.split(".")
            owner = root
            for p in parents:
                if p not in owner._modules:
                    owner.add_module(p, cls())
                owner = owner._modules[p]
            owner.register_buffer(leaf, value.clone())
        torch.save({"model": root, "train_args": {}}, path)
    finally:
        for n in created:
            sys.modules.pop(n, None)


#: kind -> (the app's argv tail, a writer of the .pt, the port model).
CASES = {
    "tracknet": (["tracknet"], lambda p, m: tckpt.save_tracknet(p, m, 8, "concat"),
                 lambda: make_tracknet(8, "concat")[0]),
    "inpaintnet": (["inpaintnet"], lambda p, m: tckpt.save_inpaintnet(p, m),
                   lambda: InpaintNet()),
    "resnet": (["resnet"], tckpt.save_resnet, lambda: ResNet50Regressor()),
    "yolo_det": (["yolo", "--variant", "n", "--imgsz", "64"], tckpt.save_yolov8,
                 lambda: YOLOv8("n", 1)),
    "yolo_coco80": (["yolo", "--variant", "n", "--imgsz", "64"], save_ultralytics_module,
                    lambda: YOLOv8("n", 80)),
    "yolo_pose": (["yolo", "--variant", "n", "--imgsz", "64", "--keypoints", "13"],
                  tckpt.save_yolov8, lambda: YOLOv8("n", 1, num_keypoints=13)),
    "yolo_court": (["yolo", "--variant", "n", "--imgsz", "64", "--keypoints", "12"],
                   tckpt.save_yolov8, lambda: YOLOv8("n", 1, num_keypoints=12)),
}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """kind -> (the .pt, the port's .msgpack, the JAX app's .msgpack, the
    seeded port model)."""
    root = tmp_path_factory.mktemp("convert")
    out = {}
    for i, (kind, (argv, write, make)) in enumerate(CASES.items()):
        model = seeded(make(), 10 + i)
        pt, ours, theirs = root / f"{kind}.pt", root / f"{kind}.msgpack", root / f"{kind}_jax.msgpack"
        write(pt, model)
        assert convert_weights.main([argv[0], str(pt), str(ours), *argv[1:]]) == 0
        assert jax_convert.main([argv[0], str(pt), str(theirs), *argv[1:]]) == 0
        out[kind] = (pt, ours, theirs, model)
    return out


@pytest.mark.parametrize("kind", list(CASES))
def test_convert_equals_jax(converted, kind):
    _, ours, theirs, model = converted[kind]
    got, want = ours.read_bytes(), theirs.read_bytes()
    assert got == want  # the same keys in the same order, the same leaves
    tree = fser.msgpack_restore(got)
    assert_trees_equal(tree, fser.msgpack_restore(want))
    assert_trees_equal(msgpack_restore(got), tree)
    assert_trees_equal(msgpack_restore(want), tree)
    sd = {k: v for k, v in model.state_dict().items() if "num_batches" not in k}
    assert sum(np.asarray(v).size for v in _leaves(tree)) == sum(v.numel() for v in sd.values())


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_coco80_class_count_inferred_and_checked(converted, tmp_path):
    pt, ours, _, _ = converted["yolo_coco80"]
    kernel = fser.msgpack_restore(ours.read_bytes())["params"]["cls_0"]["proj"]["kernel"]
    assert kernel.shape[-1] == 80
    for app in (convert_weights, jax_convert):
        with pytest.raises(SystemExit):
            app.main(["yolo", str(pt), str(tmp_path / "x.msgpack"), "--variant", "n",
                      "--imgsz", "64", "--classes", "1"])
    assert convert_weights.main(["yolo", str(pt), str(tmp_path / "y.msgpack"), "--variant",
                                 "n", "--classes", "80"]) == 0


def _same_weights(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("kind", ["yolo_det", "yolo_coco80"])
def test_players_from_msgpack_equal_pt(converted, rng, kind):
    pt, ours, theirs, _ = converted[kind]
    frames = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    outs = []
    for path in (pt, ours, theirs):
        t = PlayerTracker(str(path), None, model_variant="n", compute_dtype=torch.float32,
                          device="cpu")
        t.IMGSZ = 64
        t.CONF = 0.0  # every candidate: the outputs carry the weights
        outs.append((t, t.detect_sample(frames)))
    assert outs[0][0].num_classes == outs[1][0].num_classes
    for t, out in outs[1:]:
        _same_weights(t.engine.model, outs[0][0].engine.model)
        for a, b in zip(out, outs[0][1]):
            np.testing.assert_array_equal(a, b)


def test_pose_from_msgpack_equal_pt(converted, rng):
    pt, ours, _, _ = converted["yolo_pose"]
    frames = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    a, b = (PlayerKeypointsTracker(str(p), train_image_size=64, model_variant="n",
                                   compute_dtype=torch.float32, device="cpu") for p in (pt, ours))
    _same_weights(a.engine.model, b.engine.model)
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        for key, value in a.engine.model(x.float() / 255).items():
            assert torch.equal(value, b.engine.model(x.float() / 255)[key]), key


@pytest.mark.parametrize("mode", ["yolo", "resnet"])
def test_courts_from_msgpack_equal_pt(converted, rng, mode):
    pt, ours, _, _ = converted["yolo_court" if mode == "yolo" else "resnet"]
    a, b = (KeypointsTracker(str(p), model_type=mode, model_variant="n",
                             compute_dtype=torch.float32, device="cpu") for p in (pt, ours))
    _same_weights(a.engine.model, b.engine.model)
    x = torch.from_numpy(rng.random((1, 64, 64, 3), dtype=np.float32))
    with torch.inference_mode():
        ya, yb = a.engine.model(x), b.engine.model(x)
    for key in (ya if isinstance(ya, dict) else {"out": ya}):
        assert torch.equal(ya[key] if isinstance(ya, dict) else ya,
                           yb[key] if isinstance(yb, dict) else yb)


def test_ball_from_msgpack_equal_pt(converted, rng):
    tn_pt, tn_msg, _, _ = converted["tracknet"]
    inp_pt, inp_msg, _, _ = converted["inpaintnet"]
    frames = [rng.integers(0, 256, (36, 64, 3), dtype=np.uint8) for _ in range(12)]
    cfg = BallTrackerConfig(height=32, width=64, batch_size=4, median_max_sample_num=6)
    out = []
    for tn, inp in ((tn_pt, inp_pt), (tn_msg, inp_msg)):
        t = BallTracker(str(tn), str(inp), config=cfg, compute_dtype=torch.float32,
                        device="cpu")
        t.video_info_post_init(VideoInfo(width=64, height=36, fps=30.0, total_frames=12))
        out.append((t, [b.serialize() for b in t.predict_frames(iter(frames), 12)]))
    (a, ra), (b, rb) = out
    _same_weights(a.tracknet.model, b.tracknet.model)
    _same_weights(a.inpaintnet.model, b.inpaintnet.model)
    assert (a.tracknet_seq_len, a.bg_mode, a.inpaintnet_seq_len) == \
        (b.tracknet_seq_len, b.bg_mode, b.inpaintnet_seq_len)
    assert ra == rb


def test_tracknet_msgpack_contradicting_the_config_raises(converted):
    _, tn_msg, _, _ = converted["tracknet"]
    with pytest.raises(ValueError, match="bg_mode='subtract'"):
        BallTracker(str(tn_msg), config=BallTrackerConfig(bg_mode="subtract"), device="cpu")
    with pytest.raises(ValueError, match="seq_len=4"):
        BallTracker(str(tn_msg), config=BallTrackerConfig(seq_len=4), device="cpu")


def test_bad_msgpack_never_runs_random_weights(tmp_path):
    with pytest.raises(FileNotFoundError):
        BallTracker(str(tmp_path / "missing.msgpack"), device="cpu")
    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(b"\x81\xa6params\xd4\x09\x00")  # ext code 9
    for make in (lambda: BallTracker(str(bad), device="cpu"),
                 lambda: PlayerTracker(str(bad), None, model_variant="n", device="cpu"),
                 lambda: KeypointsTracker(str(bad), model_type="resnet", device="cpu")):
        with pytest.raises(ValueError, match="unknown ext type 9"):
            make()
