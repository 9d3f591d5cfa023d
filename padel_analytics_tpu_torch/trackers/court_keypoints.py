"""Court-keypoints tracker: fixed, yolo-pose and resnet-regression modes.

Counterpart of ``padel_analytics_tpu/trackers/court_keypoints.py``, with the
reference's three modes:

- 'fixed' (the reference's default): the user's 12 clicked keypoints,
  replicated for every frame; no model, no device;
- 'yolo' (`predict_sample`): a YOLOv8-pose with 12 keypoints on the frame
  squashed (PIL bicubic) to 640x640, one court a frame (NMS with max_det 1),
  keypoint ids remapped through the reference's hard-coded POINTS_MAPPER
  and rescaled by the per-axis ratios; a frame whose court clears no
  confidence gets an empty (falsy) `Keypoints`;
- 'resnet' (`predict_frames`): ResNet-50 regressing 24 sigmoid outputs, the
  normalised (x, y) of the 12 keypoints, on the frame squashed (PIL
  bilinear) to 224x224 and ImageNet-normalised.

Each model mode splits as the pose tracker does: `device_step` (the squash,
the model with every stride-1 3x3 ConvBN through kernel K1 on CUDA, and for
'yolo' the NMS candidates and their keypoints) into one packed buffer, one
download, then `host_step` (for 'yolo' the greedy NMS pass, the keypoints of
the kept candidate and the per-axis ratios). The fused pipeline runs the
same halves as its fourth sub-step.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional, Type

import numpy as np
import torch

from ..config import CourtKeypointsTrackerConfig
from ..models.convert import convert_resnet50_state_dict, load_torch_checkpoint
from ..models.layers import lecun_normal_
from ..models.resnet import ResNet50Regressor, imagenet_normalize
from ..models.yolov8 import YOLOv8
from ..ops.nms import NMSCandidates, nms_candidates, nms_select
from ..ops.packing import Layout, pack_rows, unpack_rows
from ..ops.resize import resize_plan
from ._engine import Engine, pad_batch
from .base import NoPredictFrames, NoPredictSample, Tracker
from .objects import Keypoint, Keypoints, TrackedObject
from .players import _load_yolo_pt

# The reference's hard-coded yolo-keypoint-index -> court-keypoint-id remap.
POINTS_MAPPER = {
    0: 10, 1: 11, 2: 1, 3: 0, 4: 7, 5: 9,
    6: 8, 7: 5, 8: 6, 9: 2, 10: 4, 11: 3,
}


class KeypointsTracker(Tracker):
    """Tracker of the court's 12 keypoints."""

    NUMBER_KEYPOINTS = 12
    TRAIN_IMAGE_SIZE = 640
    CONF = 0.5
    IOU = 0.7
    RESNET_SIZE = 224
    #: Pre-NMS candidate cap of the 'yolo' mode (one court is kept).
    nms_top_k = 64

    def __init__(
        self,
        model_path: Optional[str] = None,
        batch_size: int = 8,
        model_type: str = "yolo",
        fixed_keypoints_detection: Optional[Keypoints] = None,
        load_path: Optional[str | Path] = None,
        save_path: Optional[str | Path] = None,
        model_variant: str = "m",
        compute_dtype: torch.dtype = torch.bfloat16,
        config: Optional[CourtKeypointsTrackerConfig] = None,
        device: torch.device | str = "cuda",
        seed: int = 0,
    ):
        super().__init__(load_path=load_path, save_path=save_path)
        if config is not None:
            model_path = config.model_path or model_path
            batch_size = config.batch_size
            model_type = config.model_type
            model_variant = config.model_variant
            self.TRAIN_IMAGE_SIZE = config.train_image_size
            self.RESNET_SIZE = config.resnet_image_size
            self.CONF = config.conf
            self.IOU = config.iou
        if model_type not in ("resnet", "yolo"):
            raise ValueError("Unknown model type")
        self.model_type = model_type
        self.batch_size = batch_size
        self.fixed_keypoints_detection = fixed_keypoints_detection
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.video_info = None

        # No model in the fixed mode.
        self.engine: Optional[Engine] = None
        if fixed_keypoints_detection is None:
            if model_type == "yolo":
                state_dict = _load_yolo_pt(str(model_path)) if model_path else None
                model = YOLOv8(model_variant, num_classes=1, num_keypoints=self.NUMBER_KEYPOINTS)
            else:
                state_dict = _load_resnet_pt(str(model_path)) if model_path else None
                model = ResNet50Regressor(num_outputs=self.NUMBER_KEYPOINTS * 2)
            if state_dict is None:
                lecun_normal_(model, torch.Generator().manual_seed(seed))
            self.engine = Engine(model, self.device, state_dict)

    def video_info_post_init(self, video_info) -> "KeypointsTracker":
        self.video_info = video_info
        return self

    def object(self) -> Type[TrackedObject]:
        return Keypoints

    def __str__(self) -> str:
        return "keypoints_tracker"

    # -- the device and host halves of the model modes ---------------------

    def model_outputs(self, frames: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """'yolo': (B, H, W, 3) uint8 RGB frames on the tracker's device ->
        (the model's outputs on the frames squashed to TRAIN_IMAGE_SIZE, the
        (B, A) court scores that the confidence threshold gates)."""
        size = self.TRAIN_IMAGE_SIZE
        plan = resize_plan(tuple(frames.shape[1:3]), (size, size), "pil_bicubic")
        out = self.engine.model((plan.apply(frames) / 255.0).to(self.compute_dtype))
        return out, out["scores"][..., 0]

    def device_step(self, frames: torch.Tensor,
                    to_source: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, Layout]:
        """The device half of a chunk of (B, H, W, 3) uint8 RGB frames on the
        tracker's device, with no host sync, packed into one (B, nbytes)
        buffer (`ops/packing.py`) for one download. 'yolo': the per-frame
        candidate NMS (`nms_candidates`) and the top-k candidates' keypoints
        (B, k, 12, 3) in model pixels. 'resnet': the keypoints (B, 12, 2) in
        frame pixels, times `to_source` ((2,) fp32 on the device) when given."""
        if self.model_type == "yolo":
            out, scores = self.model_outputs(frames)
            cands = nms_candidates(out["boxes"], scores, conf_thres=self.CONF,
                                   iou_thres=self.IOU, top_k=self.nms_top_k)
            kpts = out["kpts"]
            top_kpts = torch.gather(kpts, 1, cands.index.long()[..., None, None].expand(
                -1, -1, *kpts.shape[2:]))
            return pack_rows([*cands, top_kpts])
        size = self.RESNET_SIZE
        h, w = frames.shape[1:3]
        plan = resize_plan((h, w), (size, size), "pil_bilinear")
        # torchvision's Resize (bilinear, antialiased), ToTensor (/255), Normalize.
        x = imagenet_normalize(plan.apply(frames) / 255.0)
        out = torch.sigmoid(self.engine.model(x.to(self.compute_dtype)))  # (B, 24) fp32
        kpts = out.reshape(-1, self.NUMBER_KEYPOINTS, 2)
        # Two fp32 products, as the JAX package: by the frame's (w, h), then
        # by the wire -> source scale. Written as fills, not uploads.
        wh = torch.full((2,), float(w), dtype=torch.float32, device=kpts.device)
        wh[1:].fill_(float(h))
        kpts = kpts * wh
        if to_source is not None:
            kpts = kpts * to_source
        return pack_rows([kpts])

    def host_step(self, packed: torch.Tensor, layout: Layout,
                  frame_hw: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
        """The host half on the downloaded rows of `device_step`'s buffer:
        (keypoints (B, 12, 2) fp32 in frame pixels, valid (B,) bool). 'yolo':
        the greedy NMS pass (one court a frame), the kept candidate's
        keypoints and the per-axis ratios; invalid frames hold zeros.
        'resnet': every frame valid."""
        if self.model_type == "resnet":
            (kpts,) = unpack_rows(packed, layout)
            return kpts.numpy(), np.ones(kpts.shape[0], bool)
        *cands, top_kpts = unpack_rows(packed, layout)
        _, _, _, _, valid, kpts = nms_select(NMSCandidates(*cands), 1, payload=top_kpts)
        kpts = kpts[:, 0, :, :2].contiguous()
        h, w = frame_hw
        kpts[..., 0] *= w / self.TRAIN_IMAGE_SIZE
        kpts[..., 1] *= h / self.TRAIN_IMAGE_SIZE
        return kpts.numpy(), valid[:, 0].numpy()

    def to_keypoints(self, kpts: np.ndarray, valid: np.ndarray) -> list[Keypoints]:
        """Result objects of `host_step`'s arrays: the yolo ids remapped
        through POINTS_MAPPER and an empty (falsy) Keypoints where no court
        cleared conf, so the projection pass clears its homography there."""
        yolo = self.model_type == "yolo"
        out = []
        for f in range(kpts.shape[0]):
            if not valid[f]:
                out.append(Keypoints([]))
                continue
            out.append(Keypoints([
                Keypoint(id=POINTS_MAPPER[i] if yolo else i,
                         xy=(float(kpts[f, i, 0]), float(kpts[f, i, 1])))
                for i in range(kpts.shape[1])
            ]))
        return out

    def _predict(self, sample: np.ndarray) -> list[Keypoints]:
        """One stacked chunk, zero-padded to the batch size as the JAX
        package pads it (a short tail then runs at the batch every other
        chunk runs at): one upload, `device_step`, one download,
        `host_step`."""
        with torch.inference_mode():
            frames, n = pad_batch(torch.from_numpy(sample).to(self.device),
                                  max(self.batch_size, len(sample)))
            packed, layout = self.device_step(frames)
            kpts, valid = self.host_step(packed[:n].cpu(), layout, sample.shape[1:3])
        return self.to_keypoints(kpts, valid)

    # -- the reference's entry points ----------------------------------------

    def predict_sample(self, sample: np.ndarray, **kwargs) -> list[Keypoints]:
        if self.fixed_keypoints_detection is not None:
            return [self.fixed_keypoints_detection for _ in range(len(sample))]
        if self.model_type != "yolo":
            raise NoPredictSample()
        return self._predict(np.asarray(sample))

    def predict_frames(self, frame_generator: Iterable[np.ndarray], **kwargs) -> list[Keypoints]:
        if self.fixed_keypoints_detection is not None:
            return [self.fixed_keypoints_detection for _ in frame_generator]
        if self.model_type == "yolo":
            raise NoPredictFrames()
        predictions: list[Keypoints] = []
        buffer: list[np.ndarray] = []
        for frame in frame_generator:
            buffer.append(frame)
            if len(buffer) == self.batch_size:
                predictions += self._predict(np.stack(buffer))
                buffer = []
        if buffer:  # the tail
            predictions += self._predict(np.stack(buffer))
        return predictions


def _load_resnet_pt(path: str) -> dict[str, torch.Tensor]:
    """A torchvision resnet50 state_dict (or a pickled module holding one,
    which needs a full unpickle) -> the port's ResNet50Regressor state_dict."""
    state_dict = load_torch_checkpoint(path, allow_pickle=True)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    return convert_resnet50_state_dict(state_dict)
