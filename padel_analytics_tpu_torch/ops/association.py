"""ByteTrack multi-object association (Kalman + two-stage IoU matching).

Counterpart of ``padel_analytics_tpu/ops/association.py``, copied as it is
(numpy and scipy only): the JAX package's module cannot be imported without
JAX. It replaces supervision's ByteTrack of the reference's players tracker.
The algorithm is sequential over frames (track state carries between
frames), so it runs on the host on the gathered per-frame NMS outputs.
Defaults mirror supervision's ByteTrack: track_activation_threshold=0.25,
minimum_matching_threshold=0.8, lost_track_buffer=30, frame_rate-scaled
buffer, det_thresh = activation + 0.1, IDs starting at 1.

The Kalman filter is the standard constant-velocity model over
(cx, cy, aspect, height) with the position/velocity std weights used by
the ByteTrack reference implementation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import scipy.linalg
import scipy.optimize


def _xyxy_to_xyah(xyxy: np.ndarray) -> np.ndarray:
    w = xyxy[2] - xyxy[0]
    h = xyxy[3] - xyxy[1]
    return np.array([xyxy[0] + w / 2, xyxy[1] + h / 2, w / max(h, 1e-6), h])


def _xyah_to_xyxy(xyah: np.ndarray) -> np.ndarray:
    cx, cy, a, h = xyah
    w = a * h
    return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])


class KalmanFilter:
    """Constant-velocity Kalman filter over (cx, cy, a, h)."""

    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement: np.ndarray):
        mean = np.concatenate([measurement, np.zeros(4)])
        h = measurement[3]
        std = [
            2 * self._std_weight_position * h,
            2 * self._std_weight_position * h,
            1e-2,
            2 * self._std_weight_position * h,
            10 * self._std_weight_velocity * h,
            10 * self._std_weight_velocity * h,
            1e-5,
            10 * self._std_weight_velocity * h,
        ]
        covariance = np.diag(np.square(std))
        return mean, covariance

    def predict(self, mean, covariance):
        h = mean[3]
        std = [
            self._std_weight_position * h,
            self._std_weight_position * h,
            1e-2,
            self._std_weight_position * h,
            self._std_weight_velocity * h,
            self._std_weight_velocity * h,
            1e-5,
            self._std_weight_velocity * h,
        ]
        motion_cov = np.diag(np.square(std))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def update(self, mean, covariance, measurement):
        h = mean[3]
        std = [
            self._std_weight_position * h,
            self._std_weight_position * h,
            1e-1,
            self._std_weight_position * h,
        ]
        innovation_cov = np.diag(np.square(std))
        projected_mean = self._update_mat @ mean
        projected_cov = (
            self._update_mat @ covariance @ self._update_mat.T + innovation_cov
        )
        chol, lower = scipy.linalg.cho_factor(projected_cov, check_finite=False)
        kalman_gain = scipy.linalg.cho_solve(
            (chol, lower),
            (covariance @ self._update_mat.T).T,
            check_finite=False,
        ).T
        innovation = measurement - projected_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ projected_cov @ kalman_gain.T
        return new_mean, new_cov


@dataclass
class _Track:
    track_id: int
    mean: np.ndarray
    covariance: np.ndarray
    score: float
    state: str = "tracked"  # tracked | lost
    is_activated: bool = False
    frames_since_update: int = 0

    @property
    def xyxy(self) -> np.ndarray:
        return _xyah_to_xyxy(self.mean[:4])


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _linear_assignment(cost: np.ndarray, thresh: float):
    """Hungarian assignment with lap.lapjv cost_limit semantics.

    Infeasible edges (cost > thresh) are clamped to one shared value
    BEFORE the solve (supervision's scipy fallback does exactly this:
    `cost[cost > thresh] = thresh + 1e-4`), so the optimizer never trades
    a feasible pairing away to improve an infeasible one; forced clamped
    matches are dropped by the post-gate. Gating only after a raw-cost
    solve produces different match sets in crowded scenes."""
    if cost.size == 0:
        return [], list(range(cost.shape[0])), list(range(cost.shape[1]))
    cost = np.where(cost > thresh, thresh + 1e-4, cost)
    rows, cols = scipy.optimize.linear_sum_assignment(cost)
    matches, un_a, un_b = [], [], []
    matched_a, matched_b = set(), set()
    for r, c in zip(rows, cols):
        if cost[r, c] <= thresh:
            matches.append((r, c))
            matched_a.add(r)
            matched_b.add(c)
    un_a = [i for i in range(cost.shape[0]) if i not in matched_a]
    un_b = [j for j in range(cost.shape[1]) if j not in matched_b]
    return matches, un_a, un_b


class ByteTrack:
    """Two-stage IoU association over per-frame detections.

    update_with_detections(xyxy, confidence) -> (tracker_ids, keep_mask):
    tracker_ids[i] is the ID for kept detection i (IDs start at 1 like
    supervision's), keep_mask selects detections that were associated —
    matching sv.ByteTrack.update_with_detections which returns only
    matched detections (players_tracker.py:367-369).
    """

    def __init__(
        self,
        track_activation_threshold: float = 0.25,
        lost_track_buffer: int = 30,
        minimum_matching_threshold: float = 0.8,
        frame_rate: float = 30.0,
    ):
        self.track_thresh = track_activation_threshold
        self.det_thresh = track_activation_threshold + 0.1
        self.match_thresh = minimum_matching_threshold
        self.buffer_size = int(frame_rate / 30.0 * lost_track_buffer)
        self.max_time_lost = max(self.buffer_size, 1)
        self.kf = KalmanFilter()
        self.tracks: list[_Track] = []
        self._next_id = 1
        self.frame_id = 0

    def reset(self) -> None:
        self.tracks = []
        self._next_id = 1
        self.frame_id = 0

    def update_with_detections(
        self, xyxy: np.ndarray, confidence: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        xyxy = np.asarray(xyxy, dtype=np.float64).reshape(-1, 4)
        confidence = np.asarray(confidence, dtype=np.float64).reshape(-1)
        self.frame_id += 1

        # Strict > / < split (supervision: remain_inds = scores > thresh,
        # inds_low = 0.1 < scores < thresh) — a score EXACTLY at the
        # threshold falls in neither bucket and is dropped entirely.
        high = confidence > self.track_thresh
        low = (confidence > 0.1) & (confidence < self.track_thresh)
        det_high_idx = np.flatnonzero(high)
        det_low_idx = np.flatnonzero(low)

        # Predict all active tracks forward. ByteTrack's multi_predict
        # zeroes the HEIGHT-velocity state of non-tracked (lost) tracks
        # before predicting, so an occluded box's size freezes instead of
        # integrating stale velocity (STrack.multi_predict).
        for t in self.tracks:
            if t.state != "tracked":
                t.mean[7] = 0.0
            t.mean, t.covariance = self.kf.predict(t.mean, t.covariance)
            t.frames_since_update += 1

        tracked = [t for t in self.tracks if t.state == "tracked" and t.is_activated]
        unconfirmed = [
            t for t in self.tracks if t.state == "tracked" and not t.is_activated
        ]
        lost = [t for t in self.tracks if t.state == "lost"]

        assigned_ids = np.full(len(confidence), -1, dtype=np.int64)

        # --- stage 1: high detections vs (tracked + lost) ---
        # ByteTrack's match_thresh (0.8) gates the COST (1 - IoU), i.e.
        # matches need IoU >= 0.2 — not IoU >= 0.8.
        pool = tracked + lost
        pool_boxes = np.array([t.xyxy for t in pool]).reshape(-1, 4)
        det_boxes = xyxy[det_high_idx]
        cost = 1.0 - _iou_matrix(pool_boxes, det_boxes)
        matches, un_track, un_det = _linear_assignment(cost, self.match_thresh)
        for r, c in matches:
            t = pool[r]
            d_i = det_high_idx[c]
            t.mean, t.covariance = self.kf.update(
                t.mean, t.covariance, _xyxy_to_xyah(xyxy[d_i])
            )
            t.state = "tracked"
            t.is_activated = True
            t.frames_since_update = 0
            t.score = confidence[d_i]
            assigned_ids[d_i] = t.track_id

        # --- stage 2: low detections vs remaining tracked ---
        remaining_tracked = [
            pool[r] for r in un_track if pool[r].state == "tracked"
        ]
        if len(det_low_idx):
            boxes_r = np.array([t.xyxy for t in remaining_tracked]).reshape(-1, 4)
            cost2 = 1.0 - _iou_matrix(boxes_r, xyxy[det_low_idx])
            matches2, un_track2, _ = _linear_assignment(cost2, 0.5)
            for r, c in matches2:
                t = remaining_tracked[r]
                d_i = det_low_idx[c]
                t.mean, t.covariance = self.kf.update(
                    t.mean, t.covariance, _xyxy_to_xyah(xyxy[d_i])
                )
                t.frames_since_update = 0
                t.score = confidence[d_i]
                assigned_ids[d_i] = t.track_id
                t.is_activated = True
            lost_now = [remaining_tracked[r] for r in un_track2]
        else:
            lost_now = remaining_tracked
        for t in lost_now:
            t.state = "lost"

        # --- unconfirmed tracks vs leftover high detections ---
        leftover_high = [det_high_idx[c] for c in un_det]
        if unconfirmed:
            boxes_u = np.array([t.xyxy for t in unconfirmed]).reshape(-1, 4)
            cost3 = 1.0 - _iou_matrix(boxes_u, xyxy[leftover_high])
            # ByteTrack gates unconfirmed tracks at cost 0.7 (IoU >= 0.3).
            matches3, un_u, un_d3 = _linear_assignment(cost3, 0.7)
            for r, c in matches3:
                t = unconfirmed[r]
                d_i = leftover_high[c]
                t.mean, t.covariance = self.kf.update(
                    t.mean, t.covariance, _xyxy_to_xyah(xyxy[d_i])
                )
                t.is_activated = True
                t.frames_since_update = 0
                t.score = confidence[d_i]
                assigned_ids[d_i] = t.track_id
            for r in un_u:
                unconfirmed[r].state = "lost"
                unconfirmed[r].frames_since_update = self.max_time_lost + 1
            leftover_high = [leftover_high[c] for c in un_d3]

        # --- new tracks from leftover high detections ---
        for d_i in leftover_high:
            if confidence[d_i] < self.det_thresh:
                continue
            mean, cov = self.kf.initiate(_xyxy_to_xyah(xyxy[d_i]))
            track = _Track(
                track_id=self._next_id,
                mean=mean,
                covariance=cov,
                score=confidence[d_i],
                state="tracked",
                is_activated=self.frame_id == 1,
            )
            self._next_id += 1
            self.tracks.append(track)
            if track.is_activated:
                assigned_ids[d_i] = track.track_id

        # --- prune stale lost tracks ---
        self.tracks = [
            t
            for t in self.tracks
            if not (t.state == "lost" and t.frames_since_update > self.max_time_lost)
        ]

        keep = assigned_ids >= 0
        return assigned_ids[keep], keep
