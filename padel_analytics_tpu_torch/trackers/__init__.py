"""Trackers and the runner (the ball, players and player-pose paths so far)."""

from .ball import BallTracker
from .base import NoPredictFrames, NoPredictSample, Tracker, TrackingResults
from .objects import (
    Ball,
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
