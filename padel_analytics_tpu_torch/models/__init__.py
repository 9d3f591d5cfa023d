"""Models: TrackNet (channels-last) and the weight bridges; `FastTrackNet`,
TrackNet's forward over a Flax variables tree through kernel K1."""

from .tracknet_fast import FastTrackNet

__all__ = ["FastTrackNet"]
