"""The comparison that decides `correct`: a run's answers for one clip
against the plain reference's, number by number, each against its limit.

The answers are matched to the reference model's candidates (every anchor,
or every one scoring above half the threshold, at most 4096), not to the
reference's own NMS: a candidate that crosses a threshold or swaps places
with a neighbour between two precisions then reads as a small gap, not as a
wrong answer.

Gaps, which the control (the reference in float8) reads well above the
port in bfloat16 (the players' logits and boxes did not separate the two
on every seed; PERF.md gives the readings):

- pose_kpt_rel: the mean gap, over every pose detection emitted, between
  its 13 keypoints and the nearest candidate's (L-inf, px), each over that
  candidate's reach (its farthest keypoint from its anchor, + REACH_PX):
  the rounding of a keypoint grows with its offset from the anchor, which
  random weights make anything from a few pixels to thousands;
- court_kpt_px (a model court): as pose_kpt_rel's gap in pixels, for the
  court's 12 keypoints in id order.

Counts that no rounding can move, each with the limit 0. A `sure`
detection of the reference is one whose score, rank and neighbours leave
no room for a threshold, NMS, the detection cap or ByteTrack to decide
otherwise in another precision:

- players_frames_empty: frames with a sure player (feet well inside the
  court polygon, sure in the frame before too, so that ByteTrack has
  confirmed its track) where the port emitted no player at all. Which of
  several overlapping detections ByteTrack hands a track to is not in the
  reference, so a sure player that no emitted box matches is only
  reported (`players_sure_unmatched` beside the result), not compared;
- players_extra: emitted players that overlap no candidate scoring above
  the threshold less the margin by MATCH_IOU;
- pose_missed / pose_extra: as the players', with keypoints matched within
  POSE_MATCH of a candidate's reach;
- ball_vis_far: frames whose ball visibility is not the reference's where
  the reference heatmap's peak lies more than BALL_MARGIN logits from the
  threshold (frames the reference's InpaintNet filled are not counted);
- ball_xy_off: frames the port sees the ball in where the reference's
  ensemble map stays below the threshold less BALL_MARGIN logits within
  BALL_R heatmap pixels of the port's position: a ball made up, or put in
  the wrong place (with InpaintNet, only frames whose reference peak lies
  BALL_MARGIN above the threshold, which the port saw itself);
- csv_rows: rows of data.csv that break its form (header, one row a
  frame, the frame index, finite numbers, no position for a player the
  players lane did not emit at that frame).
"""

from __future__ import annotations

import json
import math

import numpy as np

from .reference import postprocess
from .reference.pipeline import POINTS_MAPPER, Answers, Candidates, scaled

#: Added to a pose candidate's reach (its farthest keypoint from its anchor,
#: source px) before it divides a gap.
REACH_PX = 8.0
#: A frame's ball visibility has to be the reference's where the reference
#: heatmap's peak lies this many logits from the threshold: bfloat16 moved
#: the players' scores by at most 0.34 logits.
BALL_MARGIN = 2.0
#: Where the port sees the ball, the reference's map has to reach the
#: threshold less BALL_MARGIN logits within this many heatmap pixels of its
#: position (a blob's box centre, rounded to source pixels).
BALL_R = 3
#: A detection is sure where its score lies this many logits above the
#: threshold (bfloat16 moved the players' by at most 0.34); a candidate
#: within it of a detection's score could outrank it.
SCORE_MARGIN = 1.0
#: A candidate overlapping a sure detection by more than NMS's IoU less this
#: could suppress it in another precision, and take its place.
IOU_MARGIN = 0.1
#: A sure player's family (it and whatever could take its place) has its
#: feet this share of the frame's height inside the court polygon, ...
GATE_MARGIN = 0.1
#: ... and every one of its family overlaps a sure player's family in the
#: frame before by this IoU, so that ByteTrack has confirmed its track.
PERSIST_IOU = 0.5
#: An emitted box matches a candidate's at this IoU.
MATCH_IOU = 0.5
#: An emitted pose detection matches a candidate whose keypoints lie within
#: this share of its reach (the sound runs' mean is ~0.01-0.03).
POSE_MATCH = 0.5


def parse_caches(texts: dict, n: int) -> Answers:
    """The port's JSON caches (text by tracker name) -> Answers."""
    a = Answers()
    for frame in json.loads(texts["players"]):
        a.players.append(np.array([p["xyxy"] + [p["confidence"]] for p in frame],
                                  np.float64).reshape(-1, 5))
    for frame in json.loads(texts["pose"]):
        a.pose.append(np.array([[k["xy"] for k in p["player_keypoints"]] for p in frame],
                               np.float64).reshape(-1, 13, 2))
    balls = json.loads(texts["ball"])
    a.ball = np.array([[b["xy"][0], b["xy"][1], b["visibility"]] for b in balls], np.float64)
    if "court" in texts:
        for frame in json.loads(texts["court"]):
            if not frame:
                a.court.append(None)
                continue
            by_id = {k["id"]: k["xy"] for k in frame}
            a.court.append(np.array([by_id[i] for i in sorted(POINTS_MAPPER.values())]))
    for name, got in (("players", a.players), ("pose", a.pose), ("ball", a.ball)):
        if len(got) != n:
            raise ValueError(f"the {name} cache holds {len(got)} frames for a {n}-frame clip")
    return a


def _nearest(points: np.ndarray, cands: np.ndarray) -> float:
    """The smallest L-inf distance between `points` (..., 2) and any
    candidate of `cands` (A, ...)."""
    return float(np.abs(cands - points[None]).reshape(len(cands), -1).max(axis=1).min())


def _logit(p: float) -> float:
    p = min(max(float(p), 1e-12), 1.0 - 1e-7)
    return math.log(p / (1.0 - p))


def _logits(p: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(p, np.float64), 1e-12, 1.0 - 1e-7)
    return np.log(p / (1.0 - p))


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box `a` with each of `b` (N, 4)."""
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:], b[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda x: np.clip(x[..., 2] - x[..., 0], 0, None) * np.clip(x[..., 3] - x[..., 1], 0, None)  # noqa: E731
    return inter / np.maximum(area(a) + area(b) - inter, 1e-9)


def _edge_distance(point: np.ndarray, polygon: np.ndarray) -> float:
    """The distance from `point` to the nearest edge of `polygon` (V, 2)."""
    a, b = polygon, np.roll(polygon, -1, axis=0)
    ab = b - a
    t = np.clip(((point - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-12), 0, 1)
    return float(np.linalg.norm(a + t[:, None] * ab - point, axis=-1).min())


def sure(c: Candidates, conf: float, iou: float, max_det: int) -> list:
    """The kept detections of the reference that no rounding can drop, each
    with the candidates that could take its place: (its position in `c`,
    the positions of its family). Sure: the score SCORE_MARGIN logits above
    `conf`, and fewer than `max_det` candidates that could outrank it. A
    sure detection is emitted unless NMS drops it for a kept candidate
    scoring no less (less the margin) that overlaps it by more than `iou`
    (less IOU_MARGIN); that candidate is in its family, and is emitted."""
    lg = _logits(c.score)
    lc = _logit(conf)
    pos = {int(a): i for i, a in enumerate(c.anchor)}
    out = []
    for a in c.kept:
        i = pos.get(int(a))
        if i is None or lg[i] - lc <= SCORE_MARGIN:
            continue
        near = lg >= lg[i] - SCORE_MARGIN
        if near.sum() > max_det:
            continue
        family = near & (_iou(c.nms_box[i], c.nms_box) > iou - IOU_MARGIN)
        family[i] = True
        out.append((i, np.nonzero(family)[0]))
    return out


def _players(got: Answers, ref: Answers, lane: dict, hw) -> tuple[int, int, int, int]:
    """(players_frames_empty, players_extra, the sure players looked for,
    those of them that no emitted box matches)."""
    poly = scaled(lane["polygon"], hw)
    margin = GATE_MARGIN * hw[0]
    lc = _logit(lane["conf"])
    families = []  # per frame: each sure player's family's boxes
    for c in ref.cands["players"]:
        kept = []
        for i, fam in sure(c, lane["conf"], lane["iou"], lane["max_detections"]):
            feet = np.stack([(c.answer[fam, 0] + c.answer[fam, 2]) / 2, c.answer[fam, 3]], -1)
            if min(_edge_distance(p, poly) for p in feet) >= margin and \
                    postprocess.in_polygon(feet, poly).all():
                kept.append(c.answer[fam])
        families.append(kept)
    empty = looked = unmatched = 0
    for f in range(1, len(families)):
        emitted = got.players[f][:, :4]
        before = [b for fam in families[f - 1] for b in fam]
        # Sure in the frame before as well, whichever of its family either
        # frame emits: ByteTrack has confirmed its track.
        here = [fam for fam in families[f]
                if before and min(_iou(b, np.array(before)).max() for b in fam) >= PERSIST_IOU]
        looked += len(here)
        unmatched += sum(not (len(emitted) and max(_iou(b, emitted).max() for b in fam)
                              >= MATCH_IOU) for fam in here)
        empty += bool(here) and not len(emitted)
    extra = 0
    for f, dets in enumerate(got.players):
        c = ref.cands["players"][f]
        near = c.answer[_logits(c.score) >= lc - SCORE_MARGIN]
        extra += sum(not (len(near) and _iou(d[:4], near).max() >= MATCH_IOU) for d in dets)
    return empty, extra, looked, unmatched


def _pose(got: Answers, ref: Answers, lane: dict) -> tuple[list, int, int, int]:
    """(each emitted detection's gap to its nearest candidate over that
    candidate's reach, pose_missed, pose_extra, the sure detections looked
    for)."""
    gaps, missed, looked = [], 0, 0
    for f, dets in enumerate(got.pose):
        ck, _, anchor, c = ref.cands["pose"][f]
        reach = np.abs(ck - anchor[:, None]).reshape(len(ck), -1).max(axis=1) + REACH_PX
        for k in dets:
            # A keypoint is its anchor plus an offset the head computes; its
            # rounding grows with the offset.
            d = np.abs(ck - k[None]).reshape(len(ck), -1).max(axis=1)
            i = int(np.argmin(d))
            gaps.append(float(d[i] / reach[i]))
        for _, fam in sure(c, lane["conf"], lane["iou"], lane["max_detections"]):
            looked += 1
            gap = [np.abs(dets - ck[j][None]).reshape(len(dets), -1).max(axis=1).min() / reach[j]
                   for j in fam] if len(dets) else [np.inf]
            missed += bool(min(gap) > POSE_MATCH)
    return gaps, missed, sum(g > POSE_MATCH for g in gaps), looked


def numbers(got: Answers, ref: Answers, cfg: dict, hw) -> tuple[dict, dict]:
    """Each compared number of `got` against the reference's `ref`, and how
    many of the reference's answers each count looked at."""
    gaps, pose_missed, pose_extra, pose_looked = _pose(got, ref, cfg["pose"])
    out = {"pose_kpt_rel": float(np.mean(gaps)) if gaps else 0.0,
           "pose_missed": pose_missed, "pose_extra": pose_extra}
    empty, players_extra, players_looked, unmatched = _players(got, ref, cfg["players"], hw)
    out.update(players_frames_empty=empty, players_extra=players_extra)
    g, r = np.asarray(got.ball), np.asarray(ref.ball)
    peak, pre = _logits(ref.cands["ball_peak"]), ref.cands["ball_pre_vis"]
    # Frames the reference's InpaintNet filled are left out.
    own = [f for f in range(len(g)) if not (r[f, 2] and not pre[f])]
    far = [f for f in own if abs(peak[f]) > BALL_MARGIN]
    out["ball_vis_far"] = int(sum(g[f, 2] != r[f, 2] for f in far))
    # Where the port sees a ball (and, with InpaintNet, surely saw it before
    # the inpaint pass), the reference's map near its position.
    b = cfg["ball"]
    heat = ref.cands["ball_heat"]
    sx, sy = hw[1] / b["width"], hw[0] / b["height"]
    cold = 1.0 / (1.0 + math.exp(BALL_MARGIN))
    seen = [f for f in own if g[f, 2] and not (b.get("inpaintnet") and peak[f] <= BALL_MARGIN)]
    off = 0
    for f in seen:
        x, y = int(g[f, 0] / sx), int(g[f, 1] / sy)
        win = heat[f, max(y - BALL_R, 0): y + BALL_R + 1, max(x - BALL_R, 0): x + BALL_R + 1]
        off += not (win.numel() and float(win.max()) >= cold)
    out["ball_xy_off"] = off
    if ref.cands.get("court"):
        gaps = [_nearest(k, ref.cands["court"][f][0])
                for f, k in enumerate(got.court) if k is not None]
        out["court_kpt_px"] = float(np.mean(gaps)) if gaps else 0.0
    basis = {"players_sure": players_looked, "players_sure_unmatched": unmatched,
             "pose_sure": pose_looked, "ball_far": len(far),
             "ball_seen": len(seen),
             # How far the reference's peaks lie from the threshold, and the
             # visibility flips beyond each margin (logits).
             "ball_peak_beyond": {m: int((np.abs(peak[own]) > m).sum()) for m in (0.5, 1, 2)},
             "ball_flips_beyond": {m: int(sum(g[f, 2] != r[f, 2] for f in own
                                              if abs(peak[f]) > m)) for m in (0, 0.5, 1, 2)}}
    return out, basis


def csv_columns() -> list[str]:
    """data.csv's columns after its unnamed index, as the reference repository
    writes them: the frame, each player's position, the time, then per frame
    interval its delta time and each player's deltas, velocities and
    accelerations (the distance at interval 1) and their norms."""
    names = ["frame", *(f"player{p}_{a}" for p in (1, 2, 3, 4) for a in "xy"), "time"]
    for fi in (1, 2, 3, 4):
        names.append(f"delta_time{fi}")
        for p in (1, 2, 3, 4):
            for a in "xy":
                names += [f"player{p}_delta{a}{fi}", f"player{p}_V{a}{fi}",
                          f"player{p}_deltaV{a}{fi}", f"player{p}_A{a}{fi}"]
            if fi == 1:
                names.append(f"player{p}_distance")
            names += [f"player{p}_Vnorm{fi}", f"player{p}_Anorm{fi}"]
    return names


def csv_rows(text: str, player_ids: list[set]) -> int:
    """Rows of data.csv that break its form; a wrong header or a missing or
    extra row counts as one each."""
    columns = csv_columns()
    lines = text.splitlines()
    bad = int(not lines or lines[0] != "," + ",".join(columns))
    bad += abs(len(lines) - 1 - len(player_ids))
    for i, line in enumerate(lines[1: len(player_ids) + 1]):
        fields = line.split(",")
        ok = len(fields) == len(columns) + 1 and fields[:2] == [str(i), str(i)]
        try:
            ok = ok and all(x == "" or math.isfinite(float(x)) for x in fields[2:])
        except ValueError:
            ok = False
        # A position only for a player the players lane emitted here.
        ok = ok and all(fields[2 + 2 * (p - 1)] == "" or p in player_ids[i]
                        for p in (1, 2, 3, 4))
        bad += not ok
    return bad


def player_ids(text: str) -> list[set]:
    """The ids of each frame's players in the players cache."""
    return [{p["id"] for p in frame} for frame in json.loads(text)]


def verdict(nums: dict, limits: dict) -> bool:
    """True when every number is within its limit (a number without a limit
    fails, so a new number cannot pass unset)."""
    return all(k in limits and v <= limits[k] for k, v in nums.items())


def report(nums: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in a fixed order, for the result line."""
    return {k: {"value": nums[k], "limit": limits.get(k)} for k in sorted(nums)}
