"""Ball velocity between two impact frames.

Counterpart of ``padel_analytics_tpu/analytics/velocity_estimator.py``,
the module the reference's dashboard imports (`BallVelocityEstimator`,
`ImpactType`, app.py:23) and does not ship:

- `BallVelocityEstimator(source_video_fps, players_detections,
  ball_detections, keypoints_detections)`;
- `estimate_velocity(frame_index_t0, frame_index_t1, impact_type,
  get_Vz=False) -> (BallVelocityData, BallVelocity)`; `BallVelocity.norm` in
  m/s; `BallVelocityData.draw_velocity(frames)` and the two positions
  projected to court meters.

The ball's pixel positions at the two frames are projected to metric
court coordinates through a homography from the frame's 12 court
keypoints to the canonical court (BASE_LINE x SIDE_LINE meters, origin at
the center): planar velocity = displacement / dt. The optional vertical
component takes the nearest player's box as the meter scale (its pixel
height against an average pro player's height): the ball's height at each
impact (0 for a floor impact), differenced. The homography is the port's
host float64 solve (`ops/homography.py`), as the collect pass's.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..constants import AVERAGE_PRO_PLAYER_HEIGHT, BASE_LINE, SERVICE_SIDE_LINE, SIDE_LINE
from ..ops.homography import find_homography, project_points
from ..trackers.objects import Ball, Keypoints, Players


class ImpactType(enum.Enum):
    FLOOR = "floor"
    RACKET = "racket"


def _court_template_meters() -> np.ndarray:
    """The 12 court keypoints in meters: origin at the center, x in
    [-BASE_LINE/2, BASE_LINE/2], y in [-SIDE_LINE/2, SIDE_LINE/2] (positive
    y toward the k1/k2 baseline), service lines SERVICE_SIDE_LINE meters
    from the baselines."""
    half_w = BASE_LINE / 2
    half_l = SIDE_LINE / 2
    service = SIDE_LINE / 2 - SERVICE_SIDE_LINE
    return np.array(
        [
            (-half_w, half_l),  # k1
            (half_w, half_l),  # k2
            (-half_w, service),  # k3
            (0.0, service),  # k4
            (half_w, service),  # k5
            (-half_w, 0.0),  # k6
            (half_w, 0.0),  # k7
            (-half_w, -service),  # k8
            (0.0, -service),  # k9
            (half_w, -service),  # k10
            (-half_w, -half_l),  # k11
            (half_w, -half_l),  # k12
        ]
    )


@dataclass
class BallVelocity:
    """Velocity components in meters/second."""

    vx: float
    vy: float
    vz: float = 0.0

    @property
    def norm(self) -> float:
        return math.sqrt(self.vx**2 + self.vy**2 + self.vz**2)

    @property
    def norm_kmh(self) -> float:
        return self.norm * 3.6

    def __repr__(self) -> str:
        return (
            f"BallVelocity(vx={self.vx:.2f}, vy={self.vy:.2f}, "
            f"vz={self.vz:.2f}, norm={self.norm:.2f} m/s)"
        )


@dataclass
class BallVelocityData:
    """Everything the dashboard renders for one velocity estimate."""

    frame_t0: int
    frame_t1: int
    position_t0: tuple[float, float]  # source pixels
    position_t1: tuple[float, float]
    position_t0_proj: tuple[float, float]  # meters, court frame
    position_t1_proj: tuple[float, float]
    impact_type: ImpactType
    delta_time: float

    def draw_velocity(self, frames: Sequence[np.ndarray]) -> np.ndarray:
        """The velocity vector as an arrow on the t1 frame (cv2, host)."""
        import cv2

        # A copy: cv2.arrowedLine draws in place, and the caller's frame
        # must not keep the arrow.
        frame = np.array(frames[self.frame_t1], dtype=np.uint8, copy=True)
        return cv2.arrowedLine(
            frame,
            tuple(int(v) for v in self.position_t0),
            tuple(int(v) for v in self.position_t1),
            (255, 0, 0),
            6,
        )


class BallVelocityEstimator:
    """Estimates the ball's velocity between two frames from tracker
    outputs."""

    def __init__(
        self,
        source_video_fps: float,
        players_detections: Sequence[Players],
        ball_detections: Sequence[Ball],
        keypoints_detections: Sequence[Keypoints],
    ):
        self.fps = source_video_fps
        self.players_detections = players_detections
        self.ball_detections = ball_detections
        self.keypoints_detections = keypoints_detections

    def _homography_meters(self, frame_index: int) -> np.ndarray:
        kps = self.keypoints_detections[frame_index]
        src = np.array([k.xy for k in kps.keypoints[:12]], dtype=np.float64)
        return find_homography(src, _court_template_meters())

    def _project_m(self, point, h) -> tuple[float, float]:
        p = project_points(h, np.asarray([point], dtype=np.float64))[0]
        return (float(p[0]), float(p[1]))

    def _ball_height_m(self, frame_index: int, impact_type: ImpactType) -> float:
        """The ball's height above the ground, with the nearest player's box
        as the pixel -> meter scale (an average pro player's height)."""
        if impact_type == ImpactType.FLOOR:
            return 0.0
        ball = self.ball_detections[frame_index]
        players = self.players_detections[frame_index]
        if len(players) == 0:
            return 0.0
        bx, by = ball.xy
        nearest = min(players, key=lambda p: (p.feet[0] - bx) ** 2 + (p.feet[1] - by) ** 2)
        pixel_height = max(float(nearest.height), 1.0)
        meters_per_pixel = AVERAGE_PRO_PLAYER_HEIGHT / pixel_height
        height_px = max(0.0, float(nearest.feet[1]) - float(by))
        return height_px * meters_per_pixel

    def estimate_velocity(
        self,
        frame_index_t0: int,
        frame_index_t1: int,
        impact_type: ImpactType,
        get_Vz: bool = False,
    ) -> tuple[BallVelocityData, BallVelocity]:
        if not frame_index_t0 < frame_index_t1:
            raise ValueError(f"frame_index_t0 {frame_index_t0} must precede frame_index_t1 "
                             f"{frame_index_t1}")
        ball_t0 = self.ball_detections[frame_index_t0]
        ball_t1 = self.ball_detections[frame_index_t1]

        h0 = self._homography_meters(frame_index_t0)
        h1 = self._homography_meters(frame_index_t1)
        p0 = self._project_m(ball_t0.xy, h0)
        p1 = self._project_m(ball_t1.xy, h1)

        dt = (frame_index_t1 - frame_index_t0) / self.fps
        vx = (p1[0] - p0[0]) / dt
        vy = (p1[1] - p0[1]) / dt

        vz = 0.0
        if get_Vz:
            # The interval's receiving end has the impact type the user
            # chose; its other end is a racket hit.
            z0 = self._ball_height_m(frame_index_t0, ImpactType.RACKET)
            z1 = self._ball_height_m(frame_index_t1, impact_type)
            vz = (z1 - z0) / dt

        data = BallVelocityData(
            frame_t0=frame_index_t0,
            frame_t1=frame_index_t1,
            position_t0=tuple(float(v) for v in ball_t0.xy),
            position_t1=tuple(float(v) for v in ball_t1.xy),
            position_t0_proj=p0,
            position_t1_proj=p1,
            impact_type=impact_type,
            delta_time=dt,
        )
        return data, BallVelocity(vx=vx, vy=vy, vz=vz)
