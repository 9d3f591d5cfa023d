"""Models: TrackNet (channels-last), InpaintNet, YOLOv8, ResNet-50 and the
weight bridges (the JAX package's ``models`` exports); `FastTrackNet`,
TrackNet's forward over a Flax variables tree through kernel K1."""

from .resnet import ResNet50Regressor
from .tracknet import InpaintNet, TrackNet, make_tracknet
from .tracknet_fast import FastTrackNet
from .yolov8 import YOLOV8_VARIANTS, YOLOv8

__all__ = [
    "TrackNet",
    "InpaintNet",
    "make_tracknet",
    "ResNet50Regressor",
    "YOLOv8",
    "YOLOV8_VARIANTS",
    "FastTrackNet",
]
