"""Host-side utilities: video input and output, unit conversions (the JAX
package's ``utils`` exports). OpenCV is imported by the functions that
decode or encode, not here."""

from .conversions import (
    convert_meters_to_pixel_distance,
    convert_pixel_distance_to_meters,
)
from .video import VideoInfo, frame_generator, read_video, save_video

__all__ = [
    "convert_meters_to_pixel_distance",
    "convert_pixel_distance_to_meters",
    "VideoInfo",
    "read_video",
    "save_video",
    "frame_generator",
]
