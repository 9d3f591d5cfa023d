"""Players tracker: YOLOv8 detection -> NMS -> polygon gate -> ByteTrack.

Counterpart of ``padel_analytics_tpu/trackers/players.py``, with the
reference's behaviour: conf 0.5, iou 0.7, imgsz 640 letterbox, person class
only, the on-court polygon gate on each box's bottom-centre anchor, and
ByteTrack IDs, built at video_info_post_init with the video's fps.

Per chunk of frames: one upload, then `device_step` (the letterbox,
cv2-linear matmuls, /255, YOLOv8 with every stride-1 3x3 ConvBN through
kernel K1, the person score and the NMS candidates), one download, then
`host_step` (the greedy NMS pass, the unletterbox, the clip to the frame
and the polygon gate; ops/nms.py says why) and ByteTrack frame by frame.
The fused pipeline runs the same two halves on each side of its drain.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Type

import numpy as np
import torch

from ..config import PlayersTrackerConfig
from ..core.checkpoint import checkpoint_format
from ..models.convert import (
    load_flax_state_dict,
    load_torch_checkpoint,
    yolov8_state_dict_from_ultralytics,
)
from ..models.layers import lecun_normal_
from ..models.yolov8 import YOLOv8
from ..ops.association import ByteTrack
from ..ops.nms import NMSCandidates, SaturationCounter, candidate_count, nms_candidates, nms_select
from ..ops.packing import Layout, pack_rows, unpack_rows
from ..ops.polygon import PolygonZone, bottom_centers, points_in_polygon
from ..ops.resize import letterbox_plan
from ._engine import Engine
from .base import Tracker
from .objects import Player, Players, TrackedObject


class PlayerTracker(Tracker):
    """Tracker of player objects (YOLOv8 person detection)."""

    CONF = 0.5
    IOU = 0.7
    IMGSZ = 640
    # Pre-NMS candidate cap (PlayersTrackerConfig.nms_top_k).
    nms_top_k = 128

    def __init__(
        self,
        model_path: Optional[str],
        polygon_zone: Optional[PolygonZone],
        batch_size: int = 8,
        annotator: str = "rectangle_bounding_box",
        show_confidence: bool = True,
        load_path: Optional[str | Path] = None,
        save_path: Optional[str | Path] = None,
        model_variant: str = "m",
        max_detections: int = 32,
        compute_dtype: torch.dtype = torch.bfloat16,
        num_classes: Optional[int] = None,
        config: Optional[PlayersTrackerConfig] = None,
        device: torch.device | str = "cuda",
        seed: int = 0,
    ):
        super().__init__(load_path=load_path, save_path=save_path)
        if config is not None:
            model_path = config.model_path or model_path
            batch_size = config.batch_size
            annotator = config.annotator
            show_confidence = config.show_confidence
            model_variant = config.model_variant
            max_detections = config.max_detections
            num_classes = config.num_classes or num_classes
            self.CONF = config.conf
            self.IOU = config.iou
            self.IMGSZ = config.imgsz
            self.nms_top_k = config.nms_top_k

        self.polygon_zone = polygon_zone
        self.batch_size = batch_size
        self.annotator = annotator
        self.show_confidence = show_confidence
        self.max_detections = max_detections
        self.compute_dtype = compute_dtype

        # The reference's players weight is stock COCO yolov8m.pt (80
        # classes, person selected before NMS); a custom checkpoint may have
        # any class count, read from its cls projection.
        state_dict = None
        if model_path is not None:
            state_dict = _load_yolo(str(model_path))
            ckpt_nc = int(state_dict["cls_0.proj.weight"].shape[0])
            if num_classes is not None and num_classes != ckpt_nc:
                raise ValueError(f"num_classes={num_classes} but checkpoint has {ckpt_nc}")
            num_classes = ckpt_nc
        self.num_classes = num_classes or 1
        model = YOLOv8(model_variant, self.num_classes)
        if state_dict is None:
            lecun_normal_(model, torch.Generator().manual_seed(seed))
        self.engine = Engine(model, device, state_dict)
        self.device = self.engine.device
        self.nms_saturation = SaturationCounter(str(self), self.nms_top_k)
        self.byte_track: Optional[ByteTrack] = None
        self.video_info = None

    def video_info_post_init(self, video_info) -> "PlayerTracker":
        self.video_info = video_info
        self.byte_track = ByteTrack(frame_rate=video_info.fps)
        return self

    def object(self) -> Type[TrackedObject]:
        return Players

    def draw_kwargs(self) -> dict:
        return {
            "video_info": self.video_info,
            "annotator": self.annotator,
            "show_confidence": self.show_confidence,
        }

    def __str__(self) -> str:
        return "players_tracker"

    def restart(self) -> None:
        self.results.restart()
        if self.byte_track is not None:
            self.byte_track.reset()

    # ------------------------------------------------------------------

    def model_outputs(self, frames: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """(B, H, W, 3) uint8 RGB frames on the tracker's device -> (the
        model's outputs on the letterboxed frames, the (B, A) person scores
        that the confidence threshold gates)."""
        lb = letterbox_plan(tuple(frames.shape[1:3]), self.IMGSZ)
        x = lb.apply(frames) / 255.0
        out = self.engine.model(x.to(self.compute_dtype))
        return out, _person_scores(out["scores"])

    def device_step(self, frames: torch.Tensor) -> tuple[torch.Tensor, Layout]:
        """The device half of a chunk, with no host sync: model outputs,
        per-frame candidate count and the NMS candidates, packed into one
        (B, nbytes) buffer (`ops/packing.py`) for one download."""
        out, person = self.model_outputs(frames)
        cands = nms_candidates(out["boxes"], person, conf_thres=self.CONF, iou_thres=self.IOU,
                               top_k=self.nms_top_k)
        return pack_rows([candidate_count(person, self.CONF), *cands])

    def host_step(self, packed: torch.Tensor, layout: Layout, src_hw: tuple[int, int],
                  wire=None):
        """The host half on the downloaded rows of `device_step`'s buffer:
        the greedy NMS pass, the unletterbox, the clip to the frame and the
        polygon gate. `wire`: ((wire_h, wire_w), sx, sy) where the frames
        the device step saw were downscaled from the source (the fused
        pipeline's 'derived' ingest): boxes are unletterboxed to wire pixels
        and scaled by (sx, sy) before the clip. Returns numpy (boxes (B, D,
        4) in source pixels, scores (B, D), valid (B, D))."""
        h, w = src_hw
        n_cand, *cands = unpack_rows(packed, layout)
        boxes, scores, _, _, valid = nms_select(NMSCandidates(*cands), self.max_detections)
        if wire is None:
            boxes = letterbox_plan((h, w), self.IMGSZ).boxes_to_source(boxes)
        else:
            (wire_hw, sx, sy) = wire
            boxes = letterbox_plan(tuple(wire_hw), self.IMGSZ).boxes_to_source(boxes)
            boxes = torch.stack([boxes[..., 0] * sx, boxes[..., 1] * sy,
                                 boxes[..., 2] * sx, boxes[..., 3] * sy], dim=-1)
        # ultralytics scale_boxes clips to the source frame.
        boxes = torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                             boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)
        if self.polygon_zone is not None:
            polygon = torch.from_numpy(self.polygon_zone.polygon)
            valid = valid & points_in_polygon(bottom_centers(boxes), polygon)
        self.nms_saturation.update(n_cand.numpy())
        return boxes.numpy(), scores.numpy(), valid.numpy()

    def detect_sample(self, sample: np.ndarray):
        """Detections for a stacked (B, H, W, 3) RGB uint8 chunk: one upload,
        `device_step`, one download, `host_step`."""
        with torch.inference_mode():
            packed, layout = self.device_step(torch.from_numpy(sample).to(self.device))
            return self.host_step(packed.cpu(), layout, sample.shape[1:3])

    def predict_sample(self, sample: np.ndarray, **kwargs) -> list[Players]:
        boxes, scores, valid = self.detect_sample(np.asarray(sample))
        predictions = []
        for f in range(boxes.shape[0]):
            keep = valid[f]
            ids, kept = self.byte_track.update_with_detections(boxes[f][keep], scores[f][keep])
            frame_boxes = boxes[f][keep][kept]
            frame_scores = scores[f][keep][kept]
            predictions.append(Players([
                Player(xyxy=frame_boxes[i], id=int(ids[i]), class_id=0,
                       confidence=float(frame_scores[i]))
                for i in range(len(ids))
            ]))
        return predictions


def _person_scores(cls_scores: torch.Tensor) -> torch.Tensor:
    """Per-anchor person score with ultralytics' classes=[0] semantics: an
    anchor is a person candidate only where person is its best class (the
    first on ties), so a ball-dominated anchor never enters the person NMS.
    nc = 1 is unchanged."""
    s0 = cls_scores[..., 0]
    if cls_scores.shape[-1] == 1:
        return s0
    return torch.where(cls_scores.argmax(dim=-1) == 0, s0, torch.zeros_like(s0))


def _load_yolo(path: str) -> dict[str, torch.Tensor]:
    """A YOLOv8 checkpoint -> the port's YOLOv8 state_dict: an ultralytics
    .pt (a pickled model, or a state_dict; unpickled in full, as ultralytics
    checkpoints need), or the JAX package's Flax .msgpack or orbax
    directory."""
    if checkpoint_format(path, "YOLOv8 checkpoint") != "torch":
        return load_flax_state_dict(path)
    ckpt = load_torch_checkpoint(path, allow_pickle=True)
    model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    state_dict = model.state_dict() if hasattr(model, "state_dict") else model
    return yolov8_state_dict_from_ultralytics(state_dict)
