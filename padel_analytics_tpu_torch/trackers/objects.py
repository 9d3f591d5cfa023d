"""Tracked-object result types with the reference's JSON schemas.

Counterpart of ``padel_analytics_tpu/trackers/objects.py`` (the types the
ball, players, pose and court paths need so far). Each `serialize` gives the same
dict, and so the same JSON cache bytes, as the JAX package and the
reference. Drawing imports OpenCV where it draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

# Colours in RGB order: frames are drawn on as RGB.
_BLUE_RGB = (0, 0, 255)
_RED_RGB = (255, 0, 0)
_GREEN_RGB = (0, 255, 0)


class TrackedObject:
    """An object to be tracked, one per frame."""

    @classmethod
    def from_json(cls, x):
        raise NotImplementedError

    def serialize(self):
        raise NotImplementedError

    def draw(self, frame: np.ndarray, **kwargs) -> np.ndarray:
        raise NotImplementedError


class Player(TrackedObject):
    """Single player bounding-box detection."""

    def __init__(
        self,
        xyxy,
        id: Optional[int] = None,
        class_id: int = 0,
        confidence: float = 0.0,
        projection: Optional[tuple[int, int]] = None,
    ):
        self.xyxy = np.asarray(xyxy, dtype=np.float64).reshape(4)
        self.id = int(id) if id is not None else None
        self.class_id = int(class_id)
        self.confidence = float(confidence)
        self.projection = tuple(projection) if projection is not None else None

    @property
    def top_left(self) -> tuple[int, int]:
        return tuple(int(p) for p in self.xyxy[:2])

    @property
    def bottom_right(self) -> tuple[int, int]:
        return tuple(int(p) for p in self.xyxy[2:])

    @property
    def height(self) -> float:
        return self.bottom_right[1] - self.top_left[1]

    @property
    def width(self) -> float:
        return self.bottom_right[0] - self.top_left[0]

    @property
    def midpoint(self) -> tuple[int, int]:
        return (
            int(self.top_left[0] + self.width / 2),
            int(self.top_left[1] + self.height / 2),
        )

    @property
    def feet(self) -> tuple[int, int]:
        # The court projection's anchor point.
        return (
            int(self.top_left[0] + self.width / 2),
            int(self.bottom_right[1]),
        )

    @classmethod
    def from_json(cls, x: dict) -> "Player":
        return cls(
            xyxy=x["xyxy"],
            id=x.get("id"),
            class_id=x.get("class_id", 0),
            confidence=x.get("confidence", 0.0),
            projection=x.get("projection"),
        )

    def serialize(self) -> dict:
        return {
            "id": self.id,
            "xyxy": [float(p) for p in self.xyxy],
            "projection": self.projection,
            "class_id": self.class_id,
            "confidence": self.confidence,
        }

    def draw(
        self,
        frame: np.ndarray,
        video_info=None,
        annotator: str = "rectangle_bounding_box",
        show_confidence: bool = True,
    ) -> np.ndarray:
        """Draw the player's box + id label (a cv2 equivalent of the
        reference's supervision annotators)."""
        import cv2

        h, w = frame.shape[:2]
        thickness = max(1, int(round(min(w, h) * 2 / 1080)))
        text_scale = min(w, h) * 0.6 / 1080
        tl, br = self.top_left, self.bottom_right
        if annotator == "ellipse":
            center = (int((tl[0] + br[0]) / 2), br[1])
            axes = (max(1, int(self.width / 2)), max(1, int(self.width * 0.17)))
            cv2.ellipse(frame, center, axes, 0.0, -45, 235, _BLUE_RGB, thickness)
        else:
            cv2.rectangle(frame, tl, br, _BLUE_RGB, thickness)
        label = (
            f"{self.id}: {self.confidence:.2f}" if show_confidence else f"{self.id}"
        )
        (tw, th), _ = cv2.getTextSize(
            label, cv2.FONT_HERSHEY_SIMPLEX, text_scale, thickness
        )
        tx = int((tl[0] + br[0]) / 2 - tw / 2)
        ty = max(th + 2, tl[1] - 4)
        cv2.rectangle(
            frame,
            (tx - 2, ty - th - 2),
            (tx + tw + 2, ty + 2),
            _BLUE_RGB,
            -1,
        )
        cv2.putText(
            frame,
            label,
            (tx, ty),
            cv2.FONT_HERSHEY_SIMPLEX,
            text_scale,
            (255, 255, 255),
            thickness,
        )
        return frame

    def draw_projection(self, frame: np.ndarray) -> np.ndarray:
        """Draw the player's court projection and id."""
        import cv2

        if self.projection:
            cv2.circle(frame, self.projection, 8, _BLUE_RGB[::-1], -1)
            cv2.putText(
                frame,
                str(self.id),
                (self.projection[0], self.projection[1] - 10),
                cv2.FONT_HERSHEY_SIMPLEX,
                0.9,
                _BLUE_RGB[::-1],
                2,
            )
            return frame
        raise ValueError("Inexistent projection.")


class Players(TrackedObject):
    """Per-frame collection of Player detections."""

    def __init__(self, players: list[Player]):
        self.players = list(players)

    @classmethod
    def from_json(cls, x: list[dict]) -> "Players":
        return cls([Player.from_json(p) for p in x])

    def serialize(self) -> list[dict]:
        return [p.serialize() for p in self.players]

    def __len__(self) -> int:
        return len(self.players)

    def __iter__(self) -> Iterator[Player]:
        return iter(self.players)

    def __getitem__(self, i: int) -> Player:
        return self.players[i]

    def draw(self, frame: np.ndarray, **kwargs) -> np.ndarray:
        for player in self.players:
            frame = player.draw(frame, **kwargs)
        return frame


class Ball(TrackedObject):
    """Ball detection in a frame."""

    def __init__(
        self,
        frame: int,
        xy: tuple[float, float],
        visibility: int,
        projection: Optional[tuple[int, int]] = None,
    ):
        self.frame = frame
        self.xy = tuple(xy)
        self.visibility = visibility
        self.projection = tuple(projection) if projection is not None else None

    @classmethod
    def from_json(cls, x: dict) -> "Ball":
        return cls(**x)

    def serialize(self) -> dict:
        return {
            "frame": self.frame,
            "xy": self.xy,
            "visibility": self.visibility,
            "projection": self.projection,
        }

    def asint(self) -> tuple[int, int]:
        return tuple(int(v) for v in self.xy)

    def __bool__(self) -> bool:
        # A Ball is always truthy, as a plain object is in the reference.
        return True

    def draw(self, frame: np.ndarray, **kwargs) -> np.ndarray:
        import cv2

        cv2.circle(frame, self.asint(), 6, _GREEN_RGB, -1)
        return frame

    def draw_projection(self, frame: np.ndarray) -> np.ndarray:
        """Draw the ball's court projection."""
        import cv2

        cv2.circle(frame, self.projection, 6, (255, 255, 0), -1)
        return frame


class Keypoint(TrackedObject):
    """Court keypoint."""

    def __init__(self, id: int, xy: tuple[float, float]):
        self.id = id
        self.xy = tuple(xy)

    @classmethod
    def from_json(cls, x: dict) -> "Keypoint":
        return cls(**x)

    def serialize(self) -> dict:
        return {"id": self.id, "xy": self.xy}

    def asint(self) -> tuple[int, int]:
        return tuple(int(v) for v in self.xy)

    def draw(self, frame: np.ndarray) -> np.ndarray:
        import cv2

        x, y = self.asint()
        cv2.putText(frame, str(self.id + 1), (x + 5, y - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                    (255, 255, 255), 1)
        cv2.circle(frame, (x, y), radius=6, color=_RED_RGB, thickness=-1)
        return frame


class Keypoints(TrackedObject):
    """Per-frame court keypoints, kept in id order; `keypoints[i]` looks a
    keypoint up BY ID, not by position."""

    def __init__(self, keypoints: list[Keypoint]):
        self.keypoints = sorted(keypoints, key=lambda k: k.id)
        self.keypoints_by_id = {k.id: k for k in keypoints}

    @classmethod
    def from_json(cls, x: list[dict]) -> "Keypoints":
        return cls([Keypoint.from_json(k) for k in x])

    def serialize(self) -> list[dict]:
        return [k.serialize() for k in self.keypoints]

    def __len__(self) -> int:
        return len(self.keypoints)

    def __iter__(self) -> Iterator[Keypoint]:
        return iter(self.keypoints)

    def __getitem__(self, id: int) -> Keypoint:
        return self.keypoints_by_id[id]

    def xy_array(self) -> np.ndarray:
        """(K, 2) float64 array in id order."""
        return np.array([k.xy for k in self.keypoints], dtype=np.float64)

    def draw(self, frame: np.ndarray, **kwargs) -> np.ndarray:
        for keypoint in self.keypoints:
            frame = keypoint.draw(frame)
        return frame


@dataclass
class PlayerKeypoint:
    """Single pose keypoint."""

    id: int
    name: str
    xy: tuple[float, float]

    def asint(self) -> tuple[int, int]:
        return tuple(int(v) for v in self.xy)

    @classmethod
    def from_json(cls, x: dict) -> "PlayerKeypoint":
        return cls(**x)

    def serialize(self) -> dict:
        return {"id": self.id, "name": self.name, "xy": self.xy}

    def draw(self, frame: np.ndarray) -> np.ndarray:
        import cv2

        cv2.circle(frame, self.asint(), radius=2, color=_RED_RGB, thickness=-1)
        return frame


class PlayerKeypoints:
    """One player's 13 pose keypoints + skeleton."""

    KEYPOINTS_NAMES = [
        "left_foot",
        "right_foot",
        "torso",
        "right_shoulder",
        "left_shoulder",
        "head",
        "neck",
        "left_hand",
        "right_hand",
        "right_knee",
        "left_knee",
        "right_elbow",
        "left_elbow",
    ]

    CONNECTIONS = [
        ("left_foot", "left_knee"),
        ("left_knee", "torso"),
        ("right_foot", "right_knee"),
        ("right_knee", "torso"),
        ("torso", "left_shoulder"),
        ("torso", "right_shoulder"),
        ("left_hand", "left_elbow"),
        ("left_elbow", "left_shoulder"),
        ("left_shoulder", "neck"),
        ("neck", "head"),
        ("right_hand", "right_elbow"),
        ("right_elbow", "right_shoulder"),
        ("right_shoulder", "neck"),
    ]

    def __init__(self, player_keypoints: list[PlayerKeypoint]):
        self.player_keypoints = list(player_keypoints)
        self.keypoints_by_name = {k.name: k for k in self.player_keypoints}

    @classmethod
    def from_json(cls, x: dict) -> "PlayerKeypoints":
        return cls([PlayerKeypoint.from_json(k) for k in x["player_keypoints"]])

    def serialize(self) -> dict:
        return {
            "player_keypoints": [k.serialize() for k in self.player_keypoints]
        }

    def __len__(self) -> int:
        return len(self.player_keypoints)

    def __iter__(self) -> Iterator[PlayerKeypoint]:
        return iter(self.player_keypoints)

    def __getitem__(self, name: str) -> PlayerKeypoint:
        if name not in self.KEYPOINTS_NAMES:
            raise KeyError(f"unknown keypoint {name!r}")
        return self.keypoints_by_name[name]

    def draw(self, frame: np.ndarray) -> np.ndarray:
        import cv2

        keypoints = {k.name: k.asint() for k in self.player_keypoints}
        if not keypoints:
            return frame
        frame = frame.copy()
        for a, b in self.CONNECTIONS:
            cv2.line(frame, keypoints[a], keypoints[b], color=_RED_RGB, thickness=2)
        return frame


class PlayersKeypoints(TrackedObject):
    """Per-frame collection of all players' pose keypoints."""

    def __init__(self, players_keypoints: list[PlayerKeypoints]):
        self.players_keypoints = list(players_keypoints)

    @classmethod
    def from_json(cls, x: list[dict]) -> "PlayersKeypoints":
        return cls([PlayerKeypoints.from_json(p) for p in x])

    def serialize(self) -> list[dict]:
        return [p.serialize() for p in self.players_keypoints]

    def __len__(self) -> int:
        return len(self.players_keypoints)

    def __iter__(self) -> Iterator[PlayerKeypoints]:
        return iter(self.players_keypoints)

    def __getitem__(self, i: int) -> PlayerKeypoints:
        return self.players_keypoints[i]

    def draw(self, frame: np.ndarray, **kwargs) -> np.ndarray:
        for player_keypoints in self.players_keypoints:
            frame = player_keypoints.draw(frame)
        return frame
