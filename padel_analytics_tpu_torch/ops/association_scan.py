"""Multi-object association as a scan over frames through a fixed-size
track table, in plain torch on the table's device.

Counterpart of ``padel_analytics_tpu/ops/association_scan.py``. The host
ByteTrack (ops/association.py) is the parity path: sequential Hungarian
matching, supervision-compatible IDs. This scan keeps every step a tensor
operation on a table of `max_tracks` slots, with masks and `torch.where`
in place of branches on values, so a chunk of frames runs with no host
synchronisation; it is what `FusedPipeline.run_mesh` uses under
association='auto', and `run` under 'device'. The IDs equal the JAX
package's scan on the same detections.

Differences from host ByteTrack (the JAX package's, kept):
- greedy best-first matching (the largest IoU first, ties to the lower
  flat index) instead of Hungarian: identical except on exact-cost ties;
- constant-velocity box prediction without the Kalman covariance
  (predict = x + v, update = observation + velocity EMA); the host's
  lost-track height-velocity zeroing has no counterpart;
- a fixed table of `max_tracks` slots; IDs still allocated in first-seen
  order.

The lifecycle mirrors the host path:
- stage 1: activated tracks (tracked and lost) against high detections
  (> track_thresh), IoU >= 1 - match_thresh;
- stage 2: stage-1 leftovers still tracked (matched last frame) against low
  detections (0.1 < s < track_thresh), IoU >= 0.5; unmatched tracked
  tracks go lost;
- the unconfirmed pass: tracks spawned last frame against the leftover high
  detections at IoU >= 0.3; matched ones are activated and emit this frame,
  unmatched ones are removed at once (a one-frame false positive never
  holds an ID);
- spawn from leftover high detections >= det_thresh = track_thresh + 0.1,
  unactivated (they emit from their second hit; frame 0 activates at once);
- lost tracks expire after max_lost frames.

Stage 2 and the unconfirmed pass share rows with no stage-1 track and
columns with no stage-1 detection (confirmed against unconfirmed tracks,
low against high detections), so they run as one greedy pass over the two
blocks: greedy matching on a block-diagonal matrix is greedy on each block.
The spawns are computed in closed form (the k-th free slot takes the k-th
spawnable detection), as the JAX package's slot-by-slot scan assigns them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .nms import box_iou


class TrackState(NamedTuple):
    boxes: torch.Tensor  # (T, 4) float32 xyxy
    velocity: torch.Tensor  # (T, 4) float32 per-frame box deltas
    ids: torch.Tensor  # (T,) int32, 0 = free slot
    age_since_update: torch.Tensor  # (T,) int32
    confirmed: torch.Tensor  # (T,) bool
    next_id: torch.Tensor  # () int32


def init_state(max_tracks: int = 16, device: torch.device | str = "cpu") -> TrackState:
    return TrackState(
        boxes=torch.zeros((max_tracks, 4), dtype=torch.float32, device=device),
        velocity=torch.zeros((max_tracks, 4), dtype=torch.float32, device=device),
        ids=torch.zeros((max_tracks,), dtype=torch.int32, device=device),
        age_since_update=torch.zeros((max_tracks,), dtype=torch.int32, device=device),
        confirmed=torch.zeros((max_tracks,), dtype=torch.bool, device=device),
        next_id=torch.ones((), dtype=torch.int32, device=device),
    )


def _f32(x: float) -> float:
    """`x` rounded to float32, as the JAX package's weakly typed Python
    constants meet its float32 arrays."""
    return float(np.float32(x))


def _greedy_match(gated: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Best-first matching over a (T, D) matrix whose admissible entries are
    > 0 and the rest -1: `n_iter` rounds, each taking the largest entry
    (the first in flat order among equals) and striking its row and
    column. Returns the column of each row, -1 for none."""
    t, d = gated.shape
    dev = gated.device
    # Row 0 is a sentinel of -1s: once nothing admissible is left, every
    # entry is -1, the first of them is in row 0, and the round assigns
    # there (dropped) and strikes only -1s. Five ops a round, no host sync.
    gated = torch.cat([gated.new_full((1, d), -1.0), gated])
    flat = gated.view(-1)
    rc = torch.stack(torch.meshgrid(torch.arange(t + 1, device=dev),
                                    torch.arange(d, device=dev), indexing="ij"), -1).view(-1, 2)
    assign = torch.full((t + 1,), -1, dtype=torch.int64, device=dev)
    for _ in range(n_iter):
        k = flat.argmax().view(1)  # the first of equal maxima
        r, c = rc.index_select(0, k).unbind(1)
        assign.index_put_((r,), c)
        gated.index_fill_(0, r, -1.0)
        gated.index_fill_(1, c, -1.0)
    return assign[1:]


def _gate(iou: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, min_iou: float):
    return torch.where(rows[:, None] & cols[None, :] & (iou >= _f32(min_iou)), iou,
                       torch.full((), -1.0, device=iou.device))


def _taken(match_col: torch.Tensor, matched: torch.Tensor, d: int) -> torch.Tensor:
    """(D,) bool: the columns some matched row took."""
    out = torch.zeros((d,), dtype=torch.int32, device=match_col.device)
    return out.scatter_reduce_(0, match_col.clamp(min=0), matched.to(torch.int32),
                               reduce="amax") > 0


def _spawn_plan(free: torch.Tensor, spawnable: torch.Tensor):
    """Slot-by-slot spawning in closed form: the k-th free slot (in slot
    order) takes the k-th spawnable detection (in detection order) while
    both last. Returns (do (T,), the new IDs' offsets (T,), det index (T,),
    count)."""
    d = spawnable.shape[0]
    slot_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    do = free & (slot_rank < spawnable.sum(dtype=torch.int32))
    # The spawnable detections first, each group in index order.
    order = torch.argsort((~spawnable).to(torch.int8), stable=True)
    det_i = order[slot_rank.clamp(0, d - 1)]
    return do, slot_rank, det_i, do.sum(dtype=torch.int32)


def _step(state: TrackState, fboxes, fscores, fvalid, track_thresh: float,
          match_thresh: float, max_lost: int):
    """One frame through the table. Returns (new state, (D,) int32 IDs, 0
    for a detection that emits none)."""
    t = state.ids.shape[0]
    d = fboxes.shape[0]
    dev = fboxes.device
    det_thresh = track_thresh + 0.1
    # Strict split: a score exactly at track_thresh falls in neither bucket.
    high = fvalid & (fscores > _f32(track_thresh))
    low = fvalid & (fscores > _f32(0.1)) & (fscores < _f32(track_thresh))

    pred = state.boxes + state.velocity
    active = state.ids > 0
    pool = active & state.confirmed  # activated: tracked + lost
    unconf = active & ~state.confirmed  # spawned last frame
    tracked_prev = pool & (state.age_since_update == 0)
    iou = box_iou(pred, fboxes)

    m1 = _greedy_match(_gate(iou, pool, high, 1.0 - match_thresh), t)
    matched1 = m1 >= 0
    col_used1 = _taken(m1, matched1, d)
    # Stage 2 (tracked leftovers vs low detections) and the unconfirmed pass
    # (last frame's spawns vs leftover high detections): disjoint rows and
    # columns, one greedy pass.
    g2 = _gate(iou, tracked_prev & ~matched1, low, 0.5)
    g3 = _gate(iou, unconf, high & ~col_used1, 0.3)
    m23 = _greedy_match(torch.maximum(g2, g3), t)
    matched3 = (m23 >= 0) & unconf

    match_col = torch.where(matched1, m1, m23)
    matched = match_col >= 0
    obs = fboxes[match_col.clamp(min=0)]
    m4 = matched[:, None]
    # 0.8 * v + 0.2 * (obs - boxes) as one fused multiply-add, as the JAX
    # package's compiled scan forms it: the exact product 0.8 * v (a float32
    # product is exact in float64) plus the rounded 0.2 * (obs - boxes),
    # rounded once to float32.
    delta = (_f32(0.2) * (obs - state.boxes)).double()
    blend = (_f32(0.8) * state.velocity.double() + delta).float()
    new_vel = torch.where(m4, blend, state.velocity)
    new_boxes = torch.where(m4, obs, pred)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    new_age = torch.where(matched, zero, state.age_since_update + 1)
    new_confirmed = state.confirmed | matched3
    # Expire stale tracks; unmatched unconfirmed ones go now.
    alive = active & (new_age <= max_lost) & ~(unconf & ~matched3)
    ids = torch.where(alive, state.ids, zero)

    col_taken = _taken(match_col, matched, d)
    spawnable = high & ~col_taken & (fscores >= _f32(det_thresh))
    do, slot_rank, det_i, n_new = _spawn_plan(ids == 0, spawnable)
    ids = torch.where(do, state.next_id + slot_rank, ids)
    new_boxes = torch.where(do[:, None], fboxes[det_i], new_boxes)
    new_vel = torch.where(do[:, None], 0.0, new_vel)
    new_age = torch.where(do, zero, new_age)
    new_confirmed = new_confirmed & ~do

    # Each detection emits the ID of the confirmed track that matched it.
    emit = matched & new_confirmed & alive
    det_ids = torch.zeros((d,), dtype=torch.int32, device=dev)
    det_ids.scatter_reduce_(0, match_col.clamp(min=0), torch.where(emit, ids, zero),
                            reduce="amax")
    new_state = TrackState(boxes=new_boxes, velocity=new_vel, ids=ids,
                           age_since_update=new_age, confirmed=new_confirmed,
                           next_id=state.next_id + n_new)
    return new_state, det_ids


def _first_frame(state: TrackState, fboxes, fscores, fvalid, det_thresh: float):
    """Frame 0: every detection >= det_thresh spawns an activated track that
    emits at once (ByteTrack activates the first frame's tracks)."""
    do, slot_rank, det_i, n_new = _spawn_plan(state.ids == 0,
                                              fvalid & (fscores >= _f32(det_thresh)))
    new_ids = torch.where(do, state.next_id + slot_rank, 0)
    det_ids = torch.zeros((fboxes.shape[0],), dtype=torch.int32, device=fboxes.device)
    # A slot that spawns nothing adds a 0 to the maximum.
    det_ids.scatter_reduce_(0, det_i, new_ids, reduce="amax")
    return state._replace(boxes=torch.where(do[:, None], fboxes[det_i], state.boxes),
                          ids=torch.where(do, new_ids, state.ids),
                          confirmed=state.confirmed | do,
                          next_id=state.next_id + n_new), det_ids


def associate_chunk(state: TrackState, boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, first: bool = False, track_thresh: float = 0.25,
                    match_thresh: float = 0.8, max_lost: int = 30):
    """Scan a chunk of consecutive frames, (B, D, 4) boxes, (B, D) scores and
    validity (D >= 1 slots a frame), through a carried TrackState on its
    device. `first=True` applies the frame-0 activation to the chunk's first
    frame.

    Returns (new state, (B, D) int32 IDs, 0 = unassigned or dropped)."""
    dev = state.ids.device
    if boxes.shape[1] < 1:
        raise ValueError("the scan needs at least one detection slot a frame")
    boxes = torch.as_tensor(boxes).to(dev, torch.float32)
    scores = torch.as_tensor(scores).to(dev, torch.float32)
    valid = torch.as_tensor(valid).to(dev, torch.bool)
    out = []
    for f in range(boxes.shape[0]):
        if first and f == 0:
            state, ids = _first_frame(state, boxes[0], scores[0], valid[0], track_thresh + 0.1)
        else:
            state, ids = _step(state, boxes[f], scores[f], valid[f], track_thresh,
                               match_thresh, max_lost)
        out.append(ids)
    if not out:
        return state, torch.zeros((0, boxes.shape[1]), dtype=torch.int32, device=dev)
    return state, torch.stack(out)


def associate_clip(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                   track_thresh: float = 0.25, match_thresh: float = 0.8, max_lost: int = 30,
                   max_tracks: int = 16):
    """Track IDs for every detection of a clip in one scan on the boxes'
    device. Returns ((F, D) int32 IDs with 0 = unassigned or dropped, the
    final state)."""
    dev = torch.as_tensor(boxes).device
    state, ids = associate_chunk(init_state(max_tracks, dev), boxes, scores, valid, first=True,
                                 track_thresh=track_thresh, match_thresh=match_thresh,
                                 max_lost=max_lost)
    return ids, state
