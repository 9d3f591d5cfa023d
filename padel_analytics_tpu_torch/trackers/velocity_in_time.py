"""Ball velocity vectors over frame intervals, and hit detection.

Counterpart of ``padel_analytics_tpu/trackers/velocity_in_time.py`` (the
reference's trackers/velocity_in_time.py), host numpy over the port's
`Ball` results: the per-pair functions, their whole-clip numpy forms
(`velocity_vectors_array`, `vector_angles_array`) and `detect_hits`. cv2 is
imported by the one function that draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np

from .objects import Ball


@dataclass
class VelocityVector:
    """Displacement vector between two ball positions."""

    r0: tuple[float, float]
    r1: tuple[float, float]

    @property
    def vector(self) -> tuple[float, float]:
        return (self.r1[0] - self.r0[0], self.r1[1] - self.r0[1])

    @staticmethod
    def angle_between_vectors(u: tuple[float, float], v: tuple[float, float]) -> float:
        dot = sum(i * j for i, j in zip(u, v))
        norm_u = math.sqrt(sum(i**2 for i in u))
        norm_v = math.sqrt(sum(i**2 for i in v))
        cos_theta = dot / (norm_u * norm_v)
        # acos's domain, against rounding (the reference raises ValueError
        # on |cos| marginally above 1).
        cos_theta = max(-1.0, min(1.0, cos_theta))
        return math.degrees(math.acos(cos_theta))

    def angle(self, vector: "VelocityVector") -> float:
        return VelocityVector.angle_between_vectors(self.vector, vector.vector)

    def draw_velocity_vector(self, frame: np.ndarray) -> np.ndarray:
        import cv2

        image = frame.copy()
        return cv2.arrowedLine(
            image,
            tuple(int(x) for x in self.r0),
            tuple(int(x) for x in self.r1),
            (255, 0, 0),
            6,
        )


def generator_chuncks(sequence: Iterable[Any], sequence_length: int) -> Iterable[list[Any]]:
    """Sliding windows of `sequence_length` consecutive items (the
    reference's name)."""
    w = []
    for x in sequence:
        w.append(x)
        if len(w) == sequence_length:
            yield list(w)
            del w[0]


def get_velocity_vector_per_frame_interval(ball_detections: list[Ball],
                                           fps: float) -> list[VelocityVector]:
    return [VelocityVector(b0.xy, b1.xy) for b0, b1 in generator_chuncks(ball_detections, 2)]


def get_velocity_vectors_angle_per_frame_interval(
    velocity_vectors: list[VelocityVector],
) -> list[float]:
    angles = []
    for v0, v1 in generator_chuncks(velocity_vectors, 2):
        try:
            angles.append(v0.angle(v1))
        except ZeroDivisionError:
            angles.append(0.0)
    return angles


# ---- whole-clip numpy forms ------------------------------------------------


def velocity_vectors_array(ball_detections: list[Ball]) -> np.ndarray:
    """(N-1, 2) displacement vectors in one pass."""
    xy = np.array([b.xy for b in ball_detections], dtype=np.float64)
    return np.diff(xy, axis=0)


def vector_angles_array(vectors: np.ndarray) -> np.ndarray:
    """(N-1,) angles in degrees between consecutive vectors; 0 where a
    vector is zero (the reference appends 0.0 on division by zero)."""
    a, b = vectors[:-1], vectors[1:]
    dots = np.sum(a * b, axis=1)
    norms = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cos = np.clip(np.where(norms > 0, dots / norms, 1.0), -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def detect_hits(
    ball_detections: list[Ball],
    angle_threshold_deg: float = 50.0,
    min_speed_px: float = 3.0,
    min_gap_frames: int = 5,
) -> list[int]:
    """Candidate hit / bounce frames: sharp direction changes of the ball's
    trajectory.

    Frame f is a candidate when the angle between the incoming and the
    outgoing vector exceeds the threshold, both vectors have real
    magnitude, the ball is visible at f-1, f and f+1, the angle is a local
    maximum, and f is at least `min_gap_frames` after the previous hit."""
    vectors = velocity_vectors_array(ball_detections)
    angles = vector_angles_array(vectors)  # angle at frame i+1
    speed = np.linalg.norm(vectors, axis=1)
    vis = np.array([b.visibility for b in ball_detections])
    hits: list[int] = []
    for i in range(len(angles)):
        f = i + 1
        if angles[i] < angle_threshold_deg:
            continue
        if speed[i] < min_speed_px or speed[i + 1] < min_speed_px:
            continue
        if not (vis[f - 1] and vis[f] and vis[f + 1]):
            continue
        lo, hi = max(0, i - 2), min(len(angles), i + 3)
        if angles[i] < np.max(angles[lo:hi]):
            continue
        if hits and f - hits[-1] < min_gap_frames:
            continue
        hits.append(f)
    return hits
