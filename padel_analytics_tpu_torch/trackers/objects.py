"""Tracked-object result types with the reference's JSON schemas.

Counterpart of ``padel_analytics_tpu/trackers/objects.py`` (the types the
ball path needs so far). `Ball.serialize` gives the same dict, and so the
same JSON cache bytes, as the JAX package and the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

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
