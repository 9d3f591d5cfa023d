"""Court-keypoints tracker, fixed mode.

Counterpart of ``padel_analytics_tpu/trackers/court_keypoints.py`` in its
'fixed' mode, the reference's default: the user's 12 clicked keypoints,
replicated for every frame. It runs no model and touches no device, so the
fused pipeline takes it for free. The 'yolo' and 'resnet' modes are not
ported yet; asking for them raises NotImplementedError.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional, Type

import numpy as np

from ..config import CourtKeypointsTrackerConfig
from .base import Tracker
from .objects import Keypoints, TrackedObject

# The reference's hard-coded yolo-keypoint-index -> court-keypoint-id remap
# ('yolo' mode; kept with the constants it belongs to).
POINTS_MAPPER = {
    0: 10, 1: 11, 2: 1, 3: 0, 4: 7, 5: 9,
    6: 8, 7: 5, 8: 6, 9: 2, 10: 4, 11: 3,
}


class KeypointsTracker(Tracker):
    """Tracker of the court's 12 keypoints (fixed mode)."""

    NUMBER_KEYPOINTS = 12

    def __init__(
        self,
        model_path: Optional[str] = None,
        batch_size: int = 8,
        model_type: str = "yolo",
        fixed_keypoints_detection: Optional[Keypoints] = None,
        load_path: Optional[str | Path] = None,
        save_path: Optional[str | Path] = None,
        config: Optional[CourtKeypointsTrackerConfig] = None,
    ):
        super().__init__(load_path=load_path, save_path=save_path)
        if config is not None:
            batch_size = config.batch_size
            model_type = config.model_type
        if model_type not in ("resnet", "yolo"):
            raise ValueError("Unknown model type")
        if fixed_keypoints_detection is None:
            raise NotImplementedError(
                f"the court's {model_type!r} mode is not ported yet (ROADMAP.md Queue 1 "
                "item 9): pass fixed_keypoints_detection"
            )
        self.model_type = model_type
        self.batch_size = batch_size
        self.fixed_keypoints_detection = fixed_keypoints_detection
        self.video_info = None

    def video_info_post_init(self, video_info) -> "KeypointsTracker":
        self.video_info = video_info
        return self

    def object(self) -> Type[TrackedObject]:
        return Keypoints

    def __str__(self) -> str:
        return "keypoints_tracker"

    def predict_sample(self, sample: np.ndarray, **kwargs) -> list[Keypoints]:
        return [self.fixed_keypoints_detection for _ in range(len(sample))]

    def predict_frames(self, frame_generator: Iterable[np.ndarray], **kwargs) -> list[Keypoints]:
        return [self.fixed_keypoints_detection for _ in frame_generator]
