"""The harness's data (padel_analytics_tpu_torch/tools/) against the JAX
demos' (repository-level tools/*_demo.py) for the same seeds:

- every scene maker bit-equal: make_rally, make_scenes, make_scene_clip at
  scale 1 and 2, make_trajectory with the 16 synthesized InpaintNet rallies
  and the held-out one;
- the derived-quality demo's letterbox and squash training views equal;
- each demo's training loop feeds its steps the same batches in the same
  order (the JAX demo run as it runs, its step factory replaced by a
  recorder; the port's likewise), across an epoch boundary;
- the scene digests that chip_smoke.py checks on the card's host
  (tests/_torch_tools_cases.py).
"""

import numpy as np
import pytest

import _torch_tools_cases as cases
import _torch_tools_jax as tj
import tools.convergence_demo as jconv
import tools.derived_quality_demo as jdq
import tools.inpaint_convergence_demo as jinp
import tools.yolo_convergence_demo as jyolo
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from padel_analytics_tpu.training import data as jdata
from padel_analytics_tpu_torch.tools import convergence, inpaint_convergence, yolo_convergence
from padel_analytics_tpu_torch.tools import derived_quality as dq
from padel_analytics_tpu_torch.tools.yolo_convergence import new_yolo

pytest.importorskip("cv2")  # the scenes are drawn with OpenCV


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture()
def jax_scale():
    """The JAX demo's geometry is module state: set it, restore scale 1."""
    yield jdq._set_scale
    jdq._set_scale(1)


@pytest.mark.parametrize("n", [72, 96])
def test_make_rally_equals_jax(n):
    want = jconv.make_rally(n, 48, 80, np.random.default_rng(0))
    got = convergence.make_rally(n, 48, 80, np.random.default_rng(0))
    for name in ("frames", "coords", "visibility", "median", "coords_src"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_make_scenes_equals_jax():
    rj, rp = np.random.default_rng(0), np.random.default_rng(0)
    for n in (16, 8):  # the demo's training then evaluation scenes, in turn
        _equal(yolo_convergence.make_scenes(rp, n), jyolo.make_scenes(rj, n))


@pytest.mark.parametrize("scale", [1, 2])
def test_scene_clip_and_training_views_equal_jax(jax_scale, scale):
    jax_scale(scale)
    geo = dq.Geometry.at(scale)
    assert (geo.src_hw, geo.wire, geo.pose_full, geo.pose_fast, geo.det) == (
        jdq.SRC_HW, jdq.WIRE, jdq.POSE_FULL, jdq.POSE_FAST, jdq.DET)
    rj, rp = np.random.default_rng(0), np.random.default_rng(0)
    frames, boxes, kpts = dq.make_scene_clip(rp, 24, geo=geo)
    _equal((frames, boxes, kpts), jdq.make_scene_clip(rj, 24))
    _equal(dq.make_scene_clip(rp, 48, geo=geo), jdq.make_scene_clip(rj, 48))
    _equal(dq._letterbox_train_views(frames, boxes, geo), jdq._letterbox_train_views(frames, boxes))
    mid = round((jdq.POSE_FULL + jdq.POSE_FAST) / 2 / 32) * 32
    assert dq.pose_sizes(geo) == (jdq.POSE_FULL, mid, jdq.POSE_FAST)
    for size in dq.pose_sizes(geo):
        _equal(dq._squash_train_views(frames, boxes, kpts, size, geo),
               jdq._squash_train_views(frames, boxes, kpts, size))


def test_inpaint_rallies_equal_jax():
    """The JAX demo's rally loop (tools/inpaint_convergence_demo.py:89-99)
    on its own make_trajectory and the JAX package's synthesize_inpaint_rally."""
    rng = np.random.default_rng(0)
    want = []
    for _ in range(16):
        coords, vis = jinp.make_trajectory(rng, 400)
        want.append(jdata.synthesize_inpaint_rally(coords, vis, jinp.IMG_WH, rng, max_gap=6))
    ev_rng = np.random.default_rng(7)
    coords, vis = jinp.make_trajectory(ev_rng, 200)
    want.append(jdata.synthesize_inpaint_rally(coords, vis, jinp.IMG_WH, ev_rng, max_gap=6))
    train, ev, rest = inpaint_convergence.make_rallies(400)
    assert rest.random() == rng.random()  # the training loop's rng is left where the demo's is
    for g, w in zip(train + [ev], want):
        for name in ("coords_pred", "coords_gt", "vis_pred", "vis_gt", "inpaint_mask"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert g.img_wh == w.img_wh


# ------------------------------------------------------------------ loops


def _jax_loop(monkeypatch, module, name, run):
    rec = tj.Recorder()
    tj.patch_jit(monkeypatch)
    monkeypatch.setattr(module, name, rec.factory)
    run()
    return rec.args


def _port_loop(monkeypatch, module, run, **stubs):
    rec = tj.PortRecorder()
    for name in ("make_tracknet_train_step", "make_yolo_train_step",
                 "make_inpaintnet_train_step"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, rec.factory)
    for target, value in stubs.items():
        monkeypatch.setattr(module, target, value)
    run()
    return rec.args


def _same_batches(got, want, steps):
    assert len(got) == len(want) == steps
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), i
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"step {i}")


def test_tracknet_loop_feeds_the_jax_batches(monkeypatch):
    """18 steps of batch 4 over 65 windows: 16 a shuffled epoch, then the
    next epoch's permutation."""
    steps = 18
    from padel_analytics_tpu.training import tracknet as jtn

    monkeypatch.setattr(jtn, "init_train_state", tj.fake_state)
    monkeypatch.setattr(jconv, "evaluate", lambda *a: {})
    want = _jax_loop(monkeypatch, jtn, "make_tracknet_train_step",
                     lambda: jconv.run_demo(steps=steps, n=72, verbose=False, force_cpu=False))
    got = _port_loop(monkeypatch, convergence,
                     lambda: convergence.run_demo(steps=steps, n=72, verbose=False,
                                                  device="cpu"),
                     evaluate=lambda *a: {})
    _same_batches(got, want, steps)


def test_yolo_loop_feeds_the_jax_batches(monkeypatch):
    steps = 6  # 4 a shuffled epoch of 16 scenes
    from padel_analytics_tpu.training import yolo as jy

    monkeypatch.setattr(jy, "init_yolo_train_state", tj.fake_state)
    monkeypatch.setattr(jyolo, "evaluate_map", lambda *a: {})
    want = _jax_loop(monkeypatch, jy, "make_yolo_train_step",
                     lambda: jyolo.run_demo(steps=steps, verbose=False, force_cpu=False))
    got = _port_loop(monkeypatch, yolo_convergence,
                     lambda: yolo_convergence.run_demo(steps=steps, verbose=False, device="cpu"),
                     evaluate_map=lambda *a: {})
    _same_batches(got, want, steps)


def test_inpaint_loop_feeds_the_jax_batches(monkeypatch):
    steps = 14  # 12 a rally's sweep, then the next rally
    from padel_analytics_tpu.training import inpaintnet as jin

    monkeypatch.setattr(jinp, "masked_px_error", lambda *a: 0.0)
    want = _jax_loop(monkeypatch, jin, "make_inpaintnet_train_step",
                     lambda: jinp.run_demo(steps=steps, verbose=False, force_cpu=False))
    got = _port_loop(monkeypatch, inpaint_convergence,
                     lambda: inpaint_convergence.run_demo(steps=steps, verbose=False,
                                                          device="cpu"),
                     masked_px_error=lambda *a: 0.0)
    _same_batches(got, want, steps)


def test_derived_loops_feed_the_jax_batches(monkeypatch):
    """The detector's loop (batch 8 of 24 letterboxed views, 3 an epoch) and
    the pose loop (batch 4, round-robin over the three squash sizes)."""
    from padel_analytics_tpu.training import yolo as jy

    geo = dq.Geometry.at(1)
    frames, boxes, kpts = dq.make_scene_clip(np.random.default_rng(0), 24, geo=geo)
    imgs, gtb, hw = dq._letterbox_train_views(frames, boxes, geo)
    gts = (np.zeros(boxes.shape[:2], np.int32), gtb, np.ones(boxes.shape[:2], bool))
    monkeypatch.setattr(jy, "init_yolo_train_state", tj.fake_state)
    det_steps, pose_steps = 4, 7
    want_det = _jax_loop(monkeypatch, jy, "make_yolo_train_step", lambda: jdq._train(
        JaxYOLOv8(variant="n", num_classes=1), imgs, det_steps, 8, 2e-3, hw, False, gts))
    want_pose = _jax_loop(monkeypatch, jy, "make_yolo_train_step", lambda: jdq._train_pose_multiscale(
        JaxYOLOv8(variant="n", num_classes=1, num_keypoints=13), frames, boxes, kpts, pose_steps,
        4, 2e-3))
    got_det = _port_loop(monkeypatch, yolo_convergence, lambda: dq._train(
        new_yolo("cpu").model, imgs, det_steps, 8, 2e-3, False, gts))
    got_pose = _port_loop(monkeypatch, dq, lambda: dq._train_pose_multiscale(
        new_yolo("cpu", 13).model, frames, boxes, kpts, pose_steps, 4, 2e-3, geo))
    _same_batches(got_det, want_det, det_steps)
    _same_batches(got_pose, want_pose, pose_steps)
    assert [a[0].shape[1] for a in got_pose] == [128, 96, 64, 128, 96, 64, 128]


def test_scene_digests_are_pinned():
    """The digests chip_smoke.py holds the card's host to."""
    assert cases.scene_digests() == cases.SCENE_DIGESTS
