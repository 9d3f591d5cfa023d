"""The port's NMS, person score, polygon gate and ByteTrack against the JAX
package on the same numpy inputs. All of them must be EQUAL: the same
slots, boxes, scores, indices and validity from batched_nms (tie-heavy
scores, several classes, saturated top-k, more survivors than max_det,
empty frames), the same polygon verdicts for points kept away from the
edges, and the same ByteTrack IDs over a scripted sequence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.ops import nms as jnms
from padel_analytics_tpu.ops import polygon as jpoly
from padel_analytics_tpu.ops.association import ByteTrack as JaxByteTrack
from padel_analytics_tpu.trackers.players import _person_scores as jax_person_scores
from padel_analytics_tpu_torch.ops import nms, polygon
from padel_analytics_tpu_torch.ops.association import ByteTrack
from padel_analytics_tpu_torch.trackers.players import _person_scores
from test_nms_ultralytics_twin import ultralytics_nms_twin


def _boxes(rng, b, a, grid=False):
    cx, cy = rng.uniform(20, 300, (2, b, a))
    w, h = rng.uniform(8, 120, (2, b, a))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return (np.round(boxes) if grid else boxes).astype(np.float32)


def _tied_scores(rng, b, a):
    """Few distinct levels, most of them above the threshold: every sort
    position has ties."""
    levels = np.array([0.1, 0.55, 0.6, 0.75, 0.9], np.float32)
    return levels[rng.integers(0, len(levels), (b, a))]


def _bf16_scores(rng, b, a):
    """Sigmoid of bf16-rounded logits, as the card's model gives them."""
    logits = torch.tensor(rng.normal(0.0, 1.5, (b, a)), dtype=torch.bfloat16)
    return torch.sigmoid(logits.float()).numpy()


def _both(boxes, scores, classes=None, **kw):
    got = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          None if classes is None else torch.from_numpy(classes), **kw)
    want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                            None if classes is None else jnp.asarray(classes), **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


CASES = {
    # name: (scores maker, grid boxes, classes, kwargs)
    "ties": (_tied_scores, True, 1, dict(conf_thres=0.5, iou_thres=0.7, max_det=16, top_k=64)),
    "ties_float_boxes": (_tied_scores, False, 1,
                         dict(conf_thres=0.5, iou_thres=0.45, max_det=16, top_k=64)),
    "bf16_scores": (_bf16_scores, False, 1,
                    dict(conf_thres=0.5, iou_thres=0.7, max_det=32, top_k=128)),
    "saturated_top_k": (_tied_scores, True, 1,
                        dict(conf_thres=0.25, iou_thres=0.7, max_det=8, top_k=16)),
    "multi_class": (_tied_scores, True, 3, dict(conf_thres=0.5, iou_thres=0.5, max_det=24,
                                                top_k=96)),
    "overflow_max_det": (_tied_scores, True, 1,
                         dict(conf_thres=0.5, iou_thres=0.95, max_det=4, top_k=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_nms_equals_jax(rng, case):
    make, grid, nc, kw = CASES[case]
    b, a = 5, 300
    boxes = _boxes(rng, b, a, grid)
    scores = make(rng, b, a)
    scores[1] = 0.05  # a frame with no candidate
    classes = rng.integers(0, nc, (b, a)).astype(np.int32) if nc > 1 else None
    got, want = _both(boxes, scores, classes, **kw)
    names = ("boxes", "scores", "classes", "index", "valid")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    valid = got[4]
    assert not valid[1].any() and valid.sum() > 0
    if case == "overflow_max_det":
        assert valid.all(axis=1)[[0, 2, 3, 4]].all()  # more survivors than slots
    n_cand = nms.candidate_count(torch.from_numpy(scores), kw["conf_thres"]).numpy()
    np.testing.assert_array_equal(n_cand, np.asarray(jnms.candidate_count(
        jnp.asarray(scores), kw["conf_thres"])))
    if case == "saturated_top_k":
        assert (n_cand > kw["top_k"]).sum() >= 4


@pytest.mark.parametrize("nc,conf,iou,max_det", [(1, 0.5, 0.7, 16), (3, 0.5, 0.7, 16),
                                                 (80, 0.4, 0.6, 12)])
def test_batched_nms_matches_ultralytics_twin(rng, nc, conf, iou, max_det):
    """Distinct scores: the independent numpy twin of ultralytics' NMS."""
    a = 400
    boxes = _boxes(rng, 1, a)[0]
    flat = 0.999 - 0.998 * np.arange(a * nc) / (a * nc)
    cls_scores = rng.permutation(flat).reshape(a, nc).astype(np.float32)
    out = nms.batched_nms(torch.from_numpy(boxes)[None],
                          torch.from_numpy(cls_scores.max(1))[None],
                          torch.from_numpy(cls_scores.argmax(1).astype(np.int32))[None],
                          conf_thres=conf, iou_thres=iou, max_det=max_det, top_k=a)
    ob, os_, oc, oi, ov = (t[0].numpy() for t in out)
    tb, ts, tc, ti = ultralytics_nms_twin(boxes, cls_scores, conf, iou, max_det)
    n = int(ov.sum())
    assert n == len(ti) > 0
    np.testing.assert_array_equal(oi[:n], ti)
    np.testing.assert_array_equal(oc[:n], tc)
    np.testing.assert_allclose(ob[:n], tb, rtol=0, atol=0)
    np.testing.assert_array_equal(os_[:n], ts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_halves_equal_batched_nms(rng, case):
    """`nms_select(nms_candidates(...))`, the fused pipeline's two halves
    around its drain, equals `batched_nms`; a payload (the pose keypoints
    of the top-k candidates) is compacted into the same slots as the
    indices."""
    make, grid, nc, kw = CASES[case]
    b, a = 5, 300
    boxes = torch.from_numpy(_boxes(rng, b, a, grid))
    scores = torch.from_numpy(make(rng, b, a))
    classes = (torch.from_numpy(rng.integers(0, nc, (b, a)).astype(np.int32))
               if nc > 1 else None)
    payload = torch.arange(b * a * 2, dtype=torch.float32).reshape(b, a, 2)
    want = nms.batched_nms(boxes, scores, classes, **kw)
    cands = nms.nms_candidates(boxes, scores, classes, kw["conf_thres"], kw["iou_thres"],
                               kw["top_k"])
    top = torch.gather(payload, 1, cands.index.long()[..., None].expand(-1, -1, 2))
    *got, picked = nms.nms_select(cands, kw["max_det"], payload=top)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    index, valid = want[3], want[4]
    expect = torch.where(valid[..., None], payload[torch.arange(b)[:, None], index.clamp(min=0)],
                         torch.zeros(()))
    assert torch.equal(picked, expect)


def test_greedy_keep_stops_at_the_largest_valid_count():
    over = np.ones((2, 4, 4), bool)
    keep = nms.greedy_keep(over, np.array([0, 2]))
    assert keep.tolist() == [[False] * 4, [True, False, False, False]]
    assert not nms.greedy_keep(over, np.array([0, 0])).any()


@pytest.mark.parametrize("nc", [1, 3])
def test_person_scores_equal_jax(rng, nc):
    levels = np.array([0.2, 0.6, 0.9], np.float32)
    s = levels[rng.integers(0, 3, (2, 50, nc))]  # argmax ties: the first wins
    np.testing.assert_array_equal(_person_scores(torch.from_numpy(s)).numpy(),
                                  np.asarray(jax_person_scores(jnp.asarray(s))))


def test_box_iou_equals_jax(rng):
    a, b = _boxes(rng, 1, 40)[0], _boxes(rng, 1, 30)[0]
    np.testing.assert_array_equal(nms.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jnms.box_iou(jnp.asarray(a), jnp.asarray(b))))


def test_saturation_counter_summary(capsys):
    counter = nms.SaturationCounter("t", top_k=4)
    jcounter = jnms.SaturationCounter("t", top_k=4)
    for n in ([1, 5, 9], [2, 3], [7]):
        counter.update(np.array(n))
        jcounter.update(np.array(n))
    assert counter.summary() == jcounter.summary() == {
        "top_k": 4, "saturated_frames": 3, "total_frames": 6, "max_candidates": 9}
    assert capsys.readouterr().out.count("WARNING") == 2  # once per counter


def test_points_in_polygon_equals_jax(rng):
    """Random points, then only those further than 1e-3 px from every edge
    (float32 anchors move by far less), in float64 on both sides."""
    poly = np.array([[100, 500], [800, 480], [900, 100], [50, 120], [400, 300]], float)
    pts = rng.uniform(0, 1000, (2000, 2))
    d = _edge_distance(pts, poly)
    pts = pts[d > 1e-3]
    got = polygon.points_in_polygon(torch.from_numpy(pts), torch.from_numpy(poly)).numpy()
    want = np.asarray(jpoly.points_in_polygon(jnp.asarray(pts), jnp.asarray(poly)))
    np.testing.assert_array_equal(got, want)
    assert 0.2 < got.mean() < 0.8
    xyxy = np.array([[390, 100, 410, 300], [390, 100, 410, 900]], np.float32)
    zone, jzone = polygon.PolygonZone(poly), jpoly.PolygonZone(poly)
    assert zone.trigger(xyxy).tolist() == jzone.trigger(xyxy).tolist() == [True, False]


def _edge_distance(pts, poly):
    a, b = poly, np.roll(poly, -1, axis=0)
    ab = b - a
    t = np.clip(((pts[:, None] - a) * ab).sum(-1) / (ab * ab).sum(-1), 0, 1)
    return np.linalg.norm(pts[:, None] - (a + t[..., None] * ab), axis=-1).min(-1)


def _box(cx, cy, w=40, h=80):
    return [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]


def _scripted_frames():
    """Two players crossing, a third occluded for 6 frames then back, a
    low-confidence stretch, a late arrival and a duplicate detection."""
    frames = []
    for f in range(40):
        boxes, conf = [], []
        boxes.append(_box(100 + 15 * f, 400))
        conf.append(0.9)
        boxes.append(_box(700 - 15 * f, 410, w=44, h=86))
        conf.append(0.18 if 20 <= f < 24 else 0.85)
        if not 10 <= f < 16:
            boxes.append(_box(300 + 2 * f, 200))
            conf.append(0.8)
        if f >= 30:
            boxes.append(_box(900, 600))
            conf.append(0.6)
        if f == 33:
            boxes.append(_box(902, 601))
            conf.append(0.59)
        frames.append((np.array(boxes, np.float32), np.array(conf, np.float32)))
    return frames


def test_bytetrack_ids_equal_jax():
    port, ref = ByteTrack(frame_rate=30), JaxByteTrack(frame_rate=30)
    seen = set()
    for boxes, conf in _scripted_frames():
        ids, keep = port.update_with_detections(boxes, conf)
        jids, jkeep = ref.update_with_detections(boxes, conf)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(keep, jkeep)
        seen.update(ids.tolist())
    assert {1, 2, 3, 4} <= seen
