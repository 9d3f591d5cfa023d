"""Trackers, the fused pipeline and the runner (the ball, players, player-pose
and court paths)."""

from .ball import BallTracker
from .base import NoPredictFrames, NoPredictSample, Tracker, TrackingResults
from .court_keypoints import KeypointsTracker
from .fused import FusedPipeline
from .objects import (
    Ball,
    Keypoint,
    Keypoints,
    Player,
    PlayerKeypoint,
    PlayerKeypoints,
    Players,
    PlayersKeypoints,
    TrackedObject,
)
from .player_keypoints import PlayerKeypointsTracker
from .players import PlayerTracker
from .runner import FrameStore, TrackingRunner

__all__ = [
    "Ball",
    "BallTracker",
    "FrameStore",
    "FusedPipeline",
    "Keypoint",
    "Keypoints",
    "KeypointsTracker",
    "NoPredictFrames",
    "NoPredictSample",
    "Player",
    "PlayerKeypoint",
    "PlayerKeypoints",
    "PlayerKeypointsTracker",
    "PlayerTracker",
    "Players",
    "PlayersKeypoints",
    "TrackedObject",
    "Tracker",
    "TrackingResults",
    "TrackingRunner",
]
