"""Player pose tracker: YOLOv8-pose with 13 named keypoints.

Counterpart of ``padel_analytics_tpu/trackers/player_keypoints.py``, with
the reference's behaviour: a PIL-bicubic squash (not a letterbox) to
train_image_size (640 or 1280), conf 0.25, iou 0.7, keypoints scaled back
by the per-axis ratios, 13 keypoints named in KEYPOINTS_NAMES order.

Per chunk of frames: one upload, the squash (the dense PIL-parity matmuls),
/255, YOLOv8-pose (every stride-1 3x3 ConvBN through kernel K1) and the NMS
candidates on the device; the greedy NMS pass on the host; the kept
detections' keypoints gathered on the device by anchor index and brought
back as one (B, max_det, 13, 3) tensor.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Type

import numpy as np
import torch

from ..config import PlayerKeypointsTrackerConfig
from ..models.layers import lecun_normal_
from ..models.yolov8 import YOLOv8
from ..ops.nms import SaturationCounter, batched_nms, candidate_count
from ..ops.resize import resize_plan
from ._engine import Engine
from .base import Tracker
from .objects import PlayerKeypoint, PlayerKeypoints, PlayersKeypoints, TrackedObject
from .players import _load_yolo_pt

NUM_KEYPOINTS = 13


class PlayerKeypointsTracker(Tracker):
    """Tracker of players' pose keypoints."""

    CONF = 0.25
    IOU = 0.7
    # Pre-NMS candidate cap (PlayerKeypointsTrackerConfig.nms_top_k).
    nms_top_k = 64

    def __init__(
        self,
        model_path: Optional[str],
        train_image_size: int = 1280,
        batch_size: int = 8,
        load_path: Optional[str | Path] = None,
        save_path: Optional[str | Path] = None,
        model_variant: str = "m",
        max_detections: int = 8,
        compute_dtype: torch.dtype = torch.bfloat16,
        config: Optional[PlayerKeypointsTrackerConfig] = None,
        device: torch.device | str = "cuda",
        seed: int = 0,
    ):
        super().__init__(load_path=load_path, save_path=save_path)
        if config is not None:
            model_path = config.model_path or model_path
            train_image_size = config.train_image_size
            batch_size = config.batch_size
            model_variant = config.model_variant
            max_detections = config.max_detections
            self.CONF = config.conf
            self.IOU = config.iou
            self.nms_top_k = config.nms_top_k

        # The config enforces the reference's 640 / 1280; the tracker takes
        # any multiple of 32 (the tests use small sizes).
        self.train_image_size = train_image_size
        self.batch_size = batch_size
        self.max_detections = max_detections
        self.compute_dtype = compute_dtype

        state_dict = _load_yolo_pt(str(model_path)) if model_path is not None else None
        model = YOLOv8(model_variant, num_classes=1, num_keypoints=NUM_KEYPOINTS)
        if state_dict is None:
            lecun_normal_(model, torch.Generator().manual_seed(seed))
        self.engine = Engine(model, device, state_dict)
        self.device = self.engine.device
        self.nms_saturation = SaturationCounter(str(self), self.nms_top_k)
        self.video_info = None

    def video_info_post_init(self, video_info) -> "PlayerKeypointsTracker":
        self.video_info = video_info
        return self

    def object(self) -> Type[TrackedObject]:
        return PlayersKeypoints

    def __str__(self) -> str:
        return "players_keypoints_tracker"

    # ------------------------------------------------------------------

    def model_outputs(self, frames: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """(B, H, W, 3) uint8 RGB frames on the tracker's device -> (the
        model's outputs on the squashed frames, the (B, A) person scores
        that the confidence threshold gates)."""
        size = self.train_image_size
        plan = resize_plan(tuple(frames.shape[1:3]), (size, size), "pil_bicubic")
        out = self.engine.model((plan.apply(frames) / 255.0).to(self.compute_dtype))
        return out, out["scores"][..., 0]

    def detect_sample(self, sample: np.ndarray):
        """Pose for a stacked (B, H, W, 3) RGB uint8 chunk. Returns host
        numpy (keypoints (B, D, 13, 3) in source pixels, scores (B, D),
        valid (B, D))."""
        h, w = sample.shape[1:3]
        with torch.inference_mode():
            out, scores = self.model_outputs(torch.from_numpy(sample).to(self.device))
            n_cand = candidate_count(scores, self.CONF).cpu()
            _, scores, _, index, valid = batched_nms(
                out["boxes"], scores, conf_thres=self.CONF, iou_thres=self.IOU,
                max_det=self.max_detections, top_k=self.nms_top_k,
            )
            # Keypoints of the kept detections (empty slots gather anchor 0).
            gather = index.clamp(min=0).to(self.device, torch.int64)
            kpts = torch.gather(out["kpts"], 1, gather[..., None, None].expand(
                -1, -1, *out["kpts"].shape[2:])).cpu()
            # Squashed model space back to source pixels.
            kpts[..., 0] *= w / self.train_image_size
            kpts[..., 1] *= h / self.train_image_size
        self.nms_saturation.update(n_cand.numpy())
        return kpts.numpy(), scores.numpy(), valid.numpy()

    def predict_sample(self, sample: np.ndarray, **kwargs) -> list[PlayersKeypoints]:
        kpts, _, valid = self.detect_sample(np.asarray(sample))
        predictions = []
        for f in range(kpts.shape[0]):
            players = [
                PlayerKeypoints([
                    PlayerKeypoint(id=i, name=PlayerKeypoints.KEYPOINTS_NAMES[i],
                                   xy=(float(kpts[f, d, i, 0]), float(kpts[f, d, i, 1])))
                    for i in range(NUM_KEYPOINTS)
                ])
                for d in range(kpts.shape[1]) if valid[f, d]
            ]
            predictions.append(PlayersKeypoints(players))
        return predictions
