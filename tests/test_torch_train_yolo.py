"""The port's YOLOv8 training (`training/yolo.py`, the YOLO augmentations,
`training/evaluate.py`) against the JAX package's on the same seeded
inputs.

- CIoU within 1e-6 (with its gradient, alpha detached on both sides); the
  task-aligned assigner on the JAX tests' hand case and all-padding case,
  and on random batches equal to the JAX assigner under vmap (masks and
  indices exactly, scores and boxes within 1e-6); DFL within 1e-6;
- the detection and pose losses on random head outputs: the total and
  every part within 1e-5 (relative), the gradients of every head output
  within 1e-5 of their largest;
- hflip (with a flip_idx) on the JAX coins and mosaic4: equal;
- mAP and OKS (numpy) equal to the JAX package's;
- one and three Adam steps of YOLOv8n detect at 64 x 64 (batch 2, 4 gt
  slots) from the same weights on the same batches as the JAX package's
  jitted step: losses, gradients, parameters and running statistics within
  the bounds of tests/_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_helpers import random_jax_yolov8
from _torch_train import (
    LR,
    assert_grads,
    assert_losses,
    assert_params,
    assert_stats,
    jax_optimizer,
    port_steps,
    run_jax_steps,
)
from padel_analytics_tpu.models.yolov8 import anchor_table
from padel_analytics_tpu.training import augmentation as jaug
from padel_analytics_tpu.training import evaluate as jev
from padel_analytics_tpu.training import yolo as jyolo
from padel_analytics_tpu_torch.models.convert import state_dict_from_flax
from padel_analytics_tpu_torch.models.yolov8 import YOLOv8
from padel_analytics_tpu_torch.training import augmentation
from padel_analytics_tpu_torch.training import evaluate as tev
from padel_analytics_tpu_torch.training import yolo
from padel_analytics_tpu_torch.training.state import init_train_state

HW = (64, 64)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _gts(rng, b, m, hw=HW, nk=0):
    h, w = hw
    x1 = rng.uniform(0, w * 0.5, (b, m))
    y1 = rng.uniform(0, h * 0.5, (b, m))
    boxes = np.stack([x1, y1, x1 + rng.uniform(w * 0.2, w * 0.5, (b, m)),
                      y1 + rng.uniform(h * 0.2, h * 0.5, (b, m))], -1).astype(np.float32)
    mask = np.zeros((b, m), bool)
    mask[:, :2] = True
    mask[0, 2] = True
    labels = rng.integers(0, 2, (b, m)).astype(np.int32)
    kpts = None
    if nk:
        kx = rng.uniform(boxes[..., None, 0], boxes[..., None, 2], (b, m, nk))
        ky = rng.uniform(boxes[..., None, 1], boxes[..., None, 3], (b, m, nk))
        kv = (rng.uniform(0, 1, (b, m, nk)) < 0.7) * 2.0
        kpts = np.stack([kx, ky, kv], -1).astype(np.float32)
    return labels, boxes, mask, kpts


def test_ciou_equals_jax(rng):
    a = np.concatenate([rng.uniform(0, 30, (50, 2)), rng.uniform(35, 70, (50, 2))], -1)
    b = a + rng.normal(0, 5, a.shape)
    a, b = a.astype(np.float32), b.astype(np.float32)
    want, g_want = jax.jit(jax.value_and_grad(lambda x: jnp.sum(jyolo.ciou(x, jnp.asarray(b)))))(
        jnp.asarray(a))
    ta = _t(a).requires_grad_(True)
    got = yolo.ciou(ta, _t(b))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jyolo.ciou(a, b)), atol=1e-6)
    assert abs(float(got.sum()) - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(g_want), atol=1e-6)
    assert float(yolo.ciou(_t(a[0]), _t(a[0]))) == pytest.approx(1.0, abs=1e-6)


def test_assigner_hand_case():
    """The JAX tests' case: each gt claims only anchors inside it; an anchor
    inside both claims the better-overlap gt."""
    anc = _t(np.array([[5.0, 5.0], [15.0, 5.0], [25.0, 5.0], [60.0, 60.0]], np.float32))
    gt_boxes = _t(np.array([[0.0, 0.0, 20.0, 10.0], [10.0, 0.0, 30.0, 10.0]], np.float32))
    pd_boxes = _t(np.array([[0.0, 0.0, 20.0, 10.0], [10.0, 0.0, 30.0, 10.0],
                            [10.0, 0.0, 30.0, 10.0], [50.0, 50.0, 70.0, 70.0]], np.float32))
    fg, idx, scores, boxes = yolo.task_aligned_assign(
        torch.full((4, 1), 0.9), pd_boxes, anc, torch.zeros(2, dtype=torch.int32), gt_boxes,
        torch.ones(2, dtype=torch.bool))
    assert fg.tolist() == [True, True, True, False]
    assert idx[:3].tolist() == [0, 1, 1]
    np.testing.assert_allclose(boxes[1].numpy(), [10, 0, 30, 10])
    assert float(scores[3].sum()) == 0.0


def test_assigner_all_padding_gts():
    fg, _, scores, _ = yolo.task_aligned_assign(
        torch.full((1, 1), 0.5), _t(np.array([[0.0, 0.0, 10.0, 10.0]], np.float32)),
        _t(np.array([[5.0, 5.0]], np.float32)), torch.zeros(3, dtype=torch.int32),
        torch.zeros(3, 4), torch.zeros(3, dtype=torch.bool))
    assert not bool(fg.any())
    assert float(scores.sum()) == 0.0


def _random_out(rng, b, a, nc=2, nk=0):
    out = {"cls_logits": rng.normal(0, 2, (b, a, nc)),
           "box_logits": rng.normal(0, 1, (b, a, 4, 16))}
    centers, strides = anchor_table(*HW)
    anc = centers * strides[:, None]
    half = rng.uniform(4, 24, (b, a, 2))
    out["boxes"] = np.concatenate([anc - half, anc + half], -1)
    if nk:
        out["kpt_raw"] = rng.normal(0, 1, (b, a, nk, 3))
        out["kpts"] = np.concatenate([anc[None, :, None] + rng.normal(0, 6, (b, a, nk, 2)),
                                      rng.uniform(0, 1, (b, a, nk, 1))], -1)
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["scores"] = (1 / (1 + np.exp(-out["cls_logits"]))).astype(np.float32)
    return out, anc.astype(np.float32), strides


def test_assign_batch_equals_jax_vmap(rng):
    """In the JAX call form: every argument by its keyword."""
    out, anc, _ = _random_out(rng, 3, 84)
    labels, boxes, mask, _ = _gts(rng, 3, 5)
    args = dict(pd_scores=out["scores"], pd_bboxes=out["boxes"], anc_points_px=anc,
                gt_labels=labels, gt_bboxes=boxes, mask_gt=mask)
    want = jax.jit(jyolo.assign_batch)(**args)
    got = yolo.assign_batch(**{k: _t(v) for k, v in args.items()})
    assert int(np.asarray(want[0]).sum()) > 0  # some anchors are assigned
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_dfl_equals_jax(rng):
    logits = rng.normal(0, 1, (5, 4, 16)).astype(np.float32)
    d = rng.uniform(0, 14.99, (5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        yolo._dfl_loss(_t(logits), _t(d)).numpy(),
        np.asarray(jax.jit(jyolo._dfl_loss)(jnp.asarray(logits), jnp.asarray(d))), atol=1e-6)


@pytest.mark.parametrize("pose", [False, True], ids=["det", "pose"])
def test_losses_equal_jax(rng, pose):
    nk = 3 if pose else 0
    out, anc, strides = _random_out(rng, 2, 84, nk=nk)
    labels, boxes, mask, kpts = _gts(rng, 2, 4, nk=nk)
    leaves = ["cls_logits", "box_logits", "boxes"] + (["kpts", "kpt_raw"] if pose else [])

    def jloss(vals):
        o = dict(out, **vals)
        if pose:
            return jyolo.yolo_pose_loss(o, anc, strides, labels, boxes, kpts, mask)
        return jyolo.yolo_detection_loss(o, anc, strides, labels, boxes, mask)

    (want, parts_w), g_want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(out[k]) for k in leaves})
    t_out = {k: _t(v) for k, v in out.items()}
    for k in leaves:
        t_out[k].requires_grad_(True)
    gts = (_t(labels), _t(boxes)) + ((_t(kpts),) if pose else ()) + (_t(mask),)
    fn = yolo.yolo_pose_loss if pose else yolo.yolo_detection_loss
    got, parts = fn(t_out, _t(anc), _t(strides), *gts)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for k in parts_w:
        assert abs(float(parts[k]) - float(parts_w[k])) <= 1e-5 * abs(float(parts_w[k])) + 1e-7, k
    assert float(parts_w["box"]) > 0  # the case assigns anchors
    for k in leaves:
        gw = np.asarray(g_want[k])
        assert np.abs(t_out[k].grad.numpy() - gw).max() <= 1e-5 * np.abs(gw).max(), k


def test_hflip_and_mosaic_equal_jax(rng):
    images = rng.uniform(0, 1, (4, 8, 12, 3)).astype(np.float32)
    labels, boxes, mask, kpts = _gts(rng, 4, 3, hw=(8, 12), nk=4)
    flip_idx = [1, 0, 3, 2]
    key = jax.random.PRNGKey(4)
    want = jaug.hflip_boxes(key, images, boxes, kpts, flip_idx=flip_idx)
    coins = np.asarray(jax.random.uniform(key, (4,)) < 0.5)
    assert coins.any() and not coins.all()
    got = augmentation.hflip_boxes(None, _t(images), _t(boxes), _t(kpts), flip_idx=flip_idx,
                                   flip=coins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jaug.mosaic4(key, images, boxes, mask, labels)
    got = augmentation.mosaic4(_t(images), _t(boxes), _t(mask), _t(labels))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_map_and_oks_equal_jax(rng):
    gts = [rng.uniform(0, 50, (n, 2)) for n in (3, 0, 5)]
    gts = [np.concatenate([g, g + rng.uniform(5, 30, g.shape)], -1) for g in gts]
    preds = [np.concatenate([g + rng.normal(0, 3, g.shape), rng.uniform(0, 80, (2, 4))])
             for g in gts]
    preds = [np.concatenate([p[:, :2], np.maximum(p[:, 2:], p[:, :2] + 1)], -1) for p in preds]
    scores = [rng.uniform(0, 1, len(p)) for p in preds]
    assert tev.detection_map(preds, scores, gts) == jev.detection_map(preds, scores, gts)
    assert tev.detection_map(gts, [np.ones(len(g)) for g in gts], gts)["map"] == 1.0
    k = rng.uniform(0, 50, (6, 2))
    gk = np.concatenate([k, np.array([[2], [2], [0], [2], [1], [2]])], -1)
    pk = k + rng.normal(0, 2, k.shape)
    assert tev.oks(pk, gk, 400.0) == jev.oks(pk, gk, 400.0)
    assert tev.oks(k, gk, 400.0) == 1.0


# ------------------------------------------------------------------ steps


@pytest.fixture(scope="module")
def det_run():
    rng = np.random.default_rng(21)
    model, variables = random_jax_yolov8(rng, "n", 1, 0, HW)
    batches = []
    for _ in range(3):
        images = rng.uniform(0, 1, (2, *HW, 3)).astype(np.float32)
        labels, boxes, mask, _ = _gts(rng, 2, 4)
        batches.append((images, np.zeros_like(labels), boxes, mask))
    opt = jax_optimizer()
    state = jyolo.YoloTrainState(variables["params"], variables["batch_stats"],
                                 opt.init(variables["params"]), 0)
    step = jax.jit(jyolo.make_yolo_train_step(model, opt, HW))
    return variables, batches, *run_jax_steps(step, state, [tuple(map(jnp.asarray, b))
                                                            for b in batches])


def _port_yolo(variables, nk=0):
    model = YOLOv8("n", 1, nk)
    model.load_state_dict(state_dict_from_flax(variables))
    return init_train_state(model, LR)


def test_yolo_det_one_step_equals_jax(det_run):
    variables, batches, losses, grads, _, _ = det_run
    state = _port_yolo(variables)
    state, loss = yolo.make_yolo_train_step()(state, *map(_t, batches[0]))
    assert_losses([float(loss)], losses[:1])
    assert_grads(state.model, grads[0])


def test_yolo_det_three_steps_equal_jax(det_run):
    variables, batches, losses, _, starts, final = det_run
    state, got = port_steps(_port_yolo(variables), yolo.make_yolo_train_step(), batches, starts)
    assert_losses(got, losses)
    assert_params(state.model, final.params)
    assert_stats(state.model, final.params, final.batch_stats)
