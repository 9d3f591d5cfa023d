"""Trackers and the runner (the ball path so far)."""

from .ball import BallTracker
from .base import NoPredictFrames, NoPredictSample, Tracker, TrackingResults
from .objects import Ball, TrackedObject
from .runner import FrameStore, TrackingRunner

__all__ = [
    "Ball",
    "BallTracker",
    "FrameStore",
    "NoPredictFrames",
    "NoPredictSample",
    "TrackedObject",
    "Tracker",
    "TrackingResults",
    "TrackingRunner",
]
