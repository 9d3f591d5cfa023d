"""Player pose tracker: YOLOv8-pose with 13 named keypoints.

Counterpart of ``padel_analytics_tpu/trackers/player_keypoints.py``, with
the reference's behaviour: a PIL-bicubic squash (not a letterbox) to
train_image_size (640 or 1280), conf 0.25, iou 0.7, keypoints scaled back
by the per-axis ratios, 13 keypoints named in KEYPOINTS_NAMES order.

Per chunk of frames: one upload, then `device_step` (the squash, dense
PIL-parity matmuls, /255, YOLOv8-pose with every stride-1 3x3 ConvBN
through kernel K1, the NMS candidates and their keypoints gathered by
anchor index), one download, then `host_step` (the greedy NMS pass, whose
compaction picks the kept candidates' keypoints, and the rescale to source
pixels). The fused pipeline runs the same two halves on each side of its
drain.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Type

import numpy as np
import torch

from ..config import PlayerKeypointsTrackerConfig
from ..models.layers import lecun_normal_
from ..models.yolov8 import YOLOv8
from ..ops.nms import NMSCandidates, SaturationCounter, candidate_count, nms_candidates, nms_select
from ..ops.packing import Layout, pack_rows, unpack_rows
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

    def device_step(self, frames: torch.Tensor) -> tuple[torch.Tensor, Layout]:
        """The device half of a chunk, with no host sync: model outputs,
        per-frame candidate count, the NMS candidates and the keypoints of
        the top-k candidates (B, k, 13, 3), packed into one (B, nbytes)
        buffer (`ops/packing.py`) for one download."""
        out, scores = self.model_outputs(frames)
        cands = nms_candidates(out["boxes"], scores, conf_thres=self.CONF, iou_thres=self.IOU,
                               top_k=self.nms_top_k)
        kpts = out["kpts"]
        top_kpts = torch.gather(kpts, 1, cands.index.long()[..., None, None].expand(
            -1, -1, *kpts.shape[2:]))
        return pack_rows([candidate_count(scores, self.CONF), *cands, top_kpts])

    def host_step(self, packed: torch.Tensor, layout: Layout, src_hw: tuple[int, int]):
        """The host half on the downloaded rows of `device_step`'s buffer:
        the greedy NMS pass, whose compaction also picks the kept
        candidates' keypoints, then the squashed model space back to source
        pixels. Returns numpy (keypoints (B, D, 13, 3), scores (B, D), valid
        (B, D)); empty slots hold zeros."""
        h, w = src_hw
        n_cand, *cands, top_kpts = unpack_rows(packed, layout)
        _, scores, _, _, valid, kpts = nms_select(NMSCandidates(*cands), self.max_detections,
                                                  payload=top_kpts)
        kpts[..., 0] *= w / self.train_image_size
        kpts[..., 1] *= h / self.train_image_size
        self.nms_saturation.update(n_cand.numpy())
        return kpts.numpy(), scores.numpy(), valid.numpy()

    def detect_sample(self, sample: np.ndarray):
        """Pose for a stacked (B, H, W, 3) RGB uint8 chunk: one upload,
        `device_step`, one download, `host_step`."""
        with torch.inference_mode():
            packed, layout = self.device_step(torch.from_numpy(sample).to(self.device))
            return self.host_step(packed.cpu(), layout, sample.shape[1:3])

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
