"""2-D court projection: minimap geometry, homography, projection, drawing.

Counterpart of ``padel_analytics_tpu/analytics/projected_court.py``: the
minimap rectangle anchored top-right, the 12 court keypoints in minimap
pixels and their 12/18/22-point correspondence sets, the origin shift and
px->m conversion, the homography cache policy (once for a fixed court,
every frame otherwise), the collect half of a frame
(`collect_data_single_frame`) and its draws. The homography is the host
float64 solve of `ops/homography.py`; `project_all` projects a clip's points
in one batched numpy call. OpenCV is imported only where a frame is drawn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np

from ..constants import BASE_LINE, SERVICE_SIDE_LINE, SIDE_LINE
from ..ops.homography import find_homography, project_points
from ..trackers.objects import Ball, Keypoint, Keypoints, Player, Players
from ..utils.conversions import convert_meters_to_pixel_distance, convert_pixel_distance_to_meters
from .data_analytics import DataAnalytics

PointPixels = tuple[int, int]


class InconsistentPredictedKeypoints(Exception):
    pass


@dataclass
class Rectangle:
    """Axis-aligned rectangle."""

    top_left: PointPixels
    bottom_right: PointPixels

    @property
    def width(self) -> int:
        return self.bottom_right[0] - self.top_left[0]

    @property
    def height(self) -> int:
        return self.bottom_right[1] - self.top_left[1]

    @property
    def area(self) -> int:
        return self.width * self.height

    @property
    def perimeter(self) -> int:
        return 2 * self.width + 2 * self.height


@dataclass
class ProjectedCourtKeypoints:
    """The minimap's 12 points of interest.

        k11--------------------k12
        |                       |
        k8-----------k9--------k10
        |            |          |
        k6----------------------k7
        |            |          |
        k3-----------k4---------k5
        |                       |
        k1----------------------k2
    """

    k1: PointPixels
    k2: PointPixels
    k3: PointPixels
    k4: PointPixels
    k5: PointPixels
    k6: PointPixels
    k7: PointPixels
    k8: PointPixels
    k9: PointPixels
    k10: PointPixels
    k11: PointPixels
    k12: PointPixels

    def __post_init__(self):
        self.origin = self._get_origin()

    @property
    def width(self) -> int:
        return self.k7[0] - self.k6[0]

    @property
    def height(self) -> int:
        return self.k1[1] - self.k11[1]

    def _get_origin(self) -> PointPixels:
        delta = (int((self.k7[0] - self.k6[0]) / 2), int((self.k7[1] - self.k6[1]) / 2))
        return (self.k6[0] + delta[0], self.k6[1] + delta[1])

    def _named(self) -> list[tuple[str, PointPixels]]:
        return [(f"k{i}", getattr(self, f"k{i}")) for i in range(1, 13)]

    def keypoints(self, number_keypoints: Literal[12, 18, 22]) -> list[Keypoint]:
        """Correspondence targets, with the reference's repeated extra
        points for the 18- and 22-point homographies."""
        keypoints_12 = [Keypoint(id=i, xy=tuple(float(p) for p in v))
                        for i, (_, v) in enumerate(self._named())]
        if number_keypoints == 12:
            return keypoints_12
        if number_keypoints == 18:
            extra_names = ["k1", "k2", "k6", "k7", "k11", "k12"]
        elif number_keypoints == 22:
            extra_names = ["k1", "k2", "k3", "k5", "k6", "k7", "k8", "k10", "k11", "k12"]
        else:
            raise ValueError("number_keypoints must be 12, 18 or 22")
        return keypoints_12 + [self[k] for k in extra_names]

    def __getitem__(self, k: str) -> Keypoint:
        id = int(k.replace("k", "")) - 1
        return Keypoint(id=id, xy=tuple(float(p) for p in getattr(self, k)))

    def lines(self) -> list[tuple[PointPixels, PointPixels]]:
        return [
            (self.k1, self.k2),
            (self.k3, self.k5),
            (self.k6, self.k7),
            (self.k8, self.k10),
            (self.k11, self.k12),
            (self.k1, self.k11),
            (self.k4, self.k9),
            (self.k2, self.k12),
        ]

    def shift_point_origin(self, point: tuple[float, float],
                           dimension: Literal["pixels", "meters"]) -> tuple[float, float]:
        """Re-origin a minimap point to the court's centre, in meters when
        asked."""
        shifted = [float(point[0] - self.origin[0]), float(point[1] - self.origin[1])]
        if dimension == "meters":
            shifted = [convert_pixel_distance_to_meters(pixel_distance=p,
                                                        reference_in_meters=BASE_LINE,
                                                        reference_in_pixels=self.width)
                       for p in shifted]
        return tuple(shifted)


class ProjectedCourt:
    """Minimap geometry, homography, projection and drawing."""

    WIDTH_MULTIPLIER = 0.14
    HEIGHT_MULTIPLIER = 0.47
    BUFFER = 50
    PADDING = 20
    ALPHA = 0.5

    def __init__(self, video_info):
        self.video_info = video_info
        self.WIDTH = int(self.WIDTH_MULTIPLIER * video_info.width)
        self.HEIGHT = int(self.HEIGHT_MULTIPLIER * video_info.height)
        self._set_canvas_background_position()
        self._set_projected_court_position()
        self._set_projected_court_keypoints()
        self.H: Optional[np.ndarray] = None

    # --- geometry --------------------------------------------------------

    def _set_canvas_background_position(self) -> None:
        end_x = self.video_info.width - self.BUFFER
        end_y = self.BUFFER + self.HEIGHT
        start_x = end_x - self.WIDTH
        start_y = end_y - self.HEIGHT
        self.background_position = Rectangle(top_left=(int(start_x), int(start_y)),
                                             bottom_right=(int(end_x), int(end_y)))

    def _set_projected_court_position(self) -> None:
        start_x = self.background_position.top_left[0] + self.PADDING
        start_y = self.background_position.top_left[1] + self.PADDING
        end_x = self.background_position.bottom_right[0] - self.PADDING
        width = end_x - start_x
        height = convert_meters_to_pixel_distance(SIDE_LINE, reference_in_meters=BASE_LINE,
                                                  reference_in_pixels=width)
        self.court_position = Rectangle(top_left=(int(start_x), int(start_y)),
                                        bottom_right=(int(end_x), int(start_y + height)))

    def _set_projected_court_keypoints(self) -> None:
        cp = self.court_position
        service = convert_meters_to_pixel_distance(SERVICE_SIDE_LINE,
                                                   reference_in_meters=BASE_LINE,
                                                   reference_in_pixels=cp.width)
        mid_x = int(cp.top_left[0] + cp.width / 2)
        mid_y = int(cp.top_left[1] + cp.height / 2)
        self.court_keypoints = ProjectedCourtKeypoints(
            k1=(cp.top_left[0], cp.bottom_right[1]),
            k2=cp.bottom_right,
            k3=(cp.top_left[0], cp.bottom_right[1] - service),
            k4=(mid_x, cp.bottom_right[1] - service),
            k5=(cp.bottom_right[0], cp.bottom_right[1] - service),
            k6=(cp.top_left[0], mid_y),
            k7=(cp.bottom_right[0], mid_y),
            k8=(cp.top_left[0], cp.top_left[1] + service),
            k9=(mid_x, cp.top_left[1] + service),
            k10=(cp.bottom_right[0], cp.top_left[1] + service),
            k11=cp.top_left,
            k12=(cp.bottom_right[0], cp.top_left[1]),
        )

    # --- homography ------------------------------------------------------

    def homography_matrix(self, keypoints_detection: Keypoints) -> np.ndarray:
        """H from the detected frame keypoints to the minimap's."""
        kps = keypoints_detection.keypoints
        n = len(kps)
        if n not in (12, 18, 22):
            raise ValueError("Unhandled number of keypoints detected")
        src = np.array([k.xy for k in kps], dtype=np.float64)
        dst = np.array([k.xy for k in self.court_keypoints.keypoints(n)], dtype=np.float64)
        if src.shape != dst.shape:
            raise InconsistentPredictedKeypoints("Don't have enough source points")
        return find_homography(src, dst)

    def _homography_for(self, keypoints_detection, is_fixed: bool) -> None:
        """Fixed keypoints compute H once; moving keypoints recompute it
        every frame and clear it when the detection is missing."""
        if self.H is None:
            if keypoints_detection:
                self.H = self.homography_matrix(keypoints_detection)
        elif not is_fixed:
            if keypoints_detection:
                self.H = self.homography_matrix(keypoints_detection)
            else:
                self.H = None

    # --- projection ------------------------------------------------------

    def project_point(self, point: tuple[float, float],
                      homography_matrix: np.ndarray) -> tuple[float, float]:
        """One point through H."""
        h = np.asarray(homography_matrix)
        if h.shape != (3, 3):
            raise ValueError(f"homography must be 3x3, got {h.shape}")
        q = h @ np.array([float(point[0]), float(point[1]), 1.0])
        return (q[0] / q[2], q[1] / q[2])

    def project_all(self, points: np.ndarray, homographies: np.ndarray) -> np.ndarray:
        """Points (F, N, 2) through per-frame homographies (F, 3, 3)."""
        return project_points(homographies, points)

    def project_player(self, player_detection: Player, homography_matrix) -> Player:
        projected = self.project_point(player_detection.feet, homography_matrix)
        player_detection.projection = tuple(int(v) for v in projected)
        return player_detection

    def project_ball(self, ball_detection: Ball, homography_matrix) -> Ball:
        projected = self.project_point(ball_detection.asint(), homography_matrix)
        ball_detection.projection = tuple(int(v) for v in projected)
        return ball_detection

    # --- drawing (OpenCV) ------------------------------------------------

    def draw_background_single_frame(self, frame: np.ndarray) -> np.ndarray:
        """Blend the minimap's white canvas into the frame at ALPHA, over
        the rectangle only."""
        import cv2

        output = frame.copy()
        (x0, y0) = self.background_position.top_left
        (x1, y1) = self.background_position.bottom_right
        # +1: the reference masks with cv2.rectangle, whose bottom-right
        # corner is inclusive.
        roi = output[y0: y1 + 1, x0: x1 + 1]
        white = np.full_like(roi, 255)
        output[y0: y1 + 1, x0: x1 + 1] = cv2.addWeighted(roi, self.ALPHA, white,
                                                         1 - self.ALPHA, 0)
        return output

    def draw_projected_court_single_frame(self, frame: np.ndarray) -> np.ndarray:
        import cv2

        for _, v in self.court_keypoints._named():
            cv2.circle(frame, v, 5, (255, 0, 0), -1)
        cv2.circle(frame, self.court_keypoints.origin, 5, (0, 255, 0), -1)
        for start, end in self.court_keypoints.lines():
            cv2.line(frame, start, end, (0, 0, 0), 2)
        return frame

    # --- per-frame collect and draw ---------------------------------------

    def _collect(self, player: Player, data_analytics: DataAnalytics) -> None:
        shifted = self.court_keypoints.shift_point_origin(
            point=tuple(float(v) for v in player.projection), dimension="meters")
        data_analytics.add_player_position(id=player.id, position=shifted)

    def collect_data_single_frame(
        self,
        keypoints_detection: Optional[Keypoints],
        players_detection: Optional[Players],
        data_analytics: Optional[DataAnalytics],
        is_fixed_keypoints: bool = False,
    ) -> Optional[DataAnalytics]:
        """The collect half of `draw_projections_and_collect_data` with no
        drawing: the same homography, gates and projections feed
        DataAnalytics, so a run without render writes the same data.csv."""
        self._homography_for(keypoints_detection, is_fixed_keypoints)
        if self.H is not None and players_detection and data_analytics is not None:
            for player in players_detection:
                self._collect(self.project_player(player, self.H), data_analytics)
        return data_analytics

    def draw_projections_and_collect_data(
        self,
        frame: np.ndarray,
        keypoints_detection: Optional[Keypoints],
        players_detection: Optional[Players],
        ball_detection: Optional[Ball],
        data_analytics: Optional[DataAnalytics] = None,
        is_fixed_keypoints: bool = False,
    ) -> tuple[np.ndarray, Optional[DataAnalytics]]:
        output = self.draw_background_single_frame(frame)
        output = self.draw_projected_court_single_frame(output)
        self._homography_for(keypoints_detection, is_fixed_keypoints)
        if self.H is not None and players_detection:
            for player in players_detection:
                projected = self.project_player(player, self.H)
                if data_analytics is not None:
                    self._collect(projected, data_analytics)
                output = projected.draw_projection(output)
        # The gate is the Ball's truthiness only, as the reference's: an
        # invisible ball (xy (0, 0)) still projects through H and draws.
        if self.H is not None and ball_detection:
            output = self.project_ball(ball_detection, self.H).draw_projection(output)
        return output, data_analytics
