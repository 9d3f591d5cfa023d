"""Typed configuration for the ported trackers.

Counterpart of ``padel_analytics_tpu/config.py``: the ball, players,
player-pose and court-keypoints tracker configs, `DeviceConfig` and the
`PipelineConfig` that holds them. `from_flat` / `from_module` accept the
reference's flat config names. The JAX package's ``use_pallas`` switch has no
counterpart: on CUDA the hand-written kernels are the path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional


@dataclass
class DeviceConfig:
    """Mesh and device placement sizes, as the JAX package's. Nothing reads
    them there or here: the mesh is `parallel.make_mesh`'s, the compute dtype
    the trackers' `compute_dtype`, the chunk the runner's `fused_chunk`."""

    data_parallel: int = -1  # -1: every device
    model_parallel: int = 1
    compute_dtype: str = "bfloat16"
    frames_per_chunk: int = 64


@dataclass
class PlayersTrackerConfig:
    """YOLOv8 person detection (reference: conf .5, iou .7, imgsz 640,
    person class only)."""

    model_path: Optional[str] = None
    model_variant: str = "m"  # the reference's players weight is yolov8m
    batch_size: int = 8
    conf: float = 0.5
    iou: float = 0.7
    imgsz: int = 640
    max_detections: int = 32  # fixed-size padded detection tensor
    # None = infer from the checkpoint's cls head (stock COCO yolov8m.pt
    # has 80; the person class is selected before NMS regardless).
    num_classes: Optional[int] = None
    # Pre-NMS candidate cap (ultralytics keeps up to 30000; padel scenes
    # hold <= 4 players, so 128 is lossless here; raise it for dense scenes).
    nms_top_k: int = 128
    annotator: str = "rectangle_bounding_box"
    show_confidence: bool = True
    load_path: Optional[str] = None
    save_path: Optional[str] = None


@dataclass
class PlayerKeypointsTrackerConfig:
    """YOLOv8-pose 13-keypoint player pose (reference: conf .25, iou .7,
    train_image_size 640 or 1280)."""

    model_path: Optional[str] = None
    model_variant: str = "m"
    train_image_size: int = 1280
    batch_size: int = 8
    conf: float = 0.25
    iou: float = 0.7
    max_detections: int = 8
    num_keypoints: int = 13
    # Pre-NMS candidate cap (see PlayersTrackerConfig.nms_top_k).
    nms_top_k: int = 64
    load_path: Optional[str] = None
    save_path: Optional[str] = None

    def __post_init__(self):
        if self.train_image_size not in (640, 1280):
            raise ValueError("train_image_size must be 640 or 1280")


@dataclass
class CourtKeypointsTrackerConfig:
    """Court 12-keypoint detection (reference: 'fixed' user keypoints, a
    'yolo' pose model with a hard-coded index remap, or a 'resnet' 24-dim
    sigmoid regression)."""

    model_path: Optional[str] = None
    model_type: str = "yolo"  # "resnet" | "yolo"
    model_variant: str = "m"  # YOLOv8 variant for the 'yolo' mode
    batch_size: int = 8
    number_keypoints: int = 12
    train_image_size: int = 640
    resnet_image_size: int = 224
    conf: float = 0.5
    iou: float = 0.7
    load_path: Optional[str] = None
    save_path: Optional[str] = None

    def __post_init__(self):
        if self.model_type not in ("resnet", "yolo"):
            raise ValueError("model_type must be 'resnet' or 'yolo'")


@dataclass
class BallTrackerConfig:
    """TrackNet ball tracking (reference: 512x288, seq_len 8, stride 1,
    median over <= 400 frames)."""

    tracking_model_path: Optional[str] = None
    inpainting_model_path: Optional[str] = None
    batch_size: int = 8
    median_max_sample_num: int = 400
    seq_len: int = 8
    bg_mode: str = "concat"
    height: int = 288
    width: int = 512
    sigma: float = 2.5  # the label discs' radius (training); BallTracker.SIGMA
    eval_mode: str = "weight"  # temporal ensemble weighting
    # The exact low-resolution rewrite of the up blocks' first convs
    # (models/tracknet.py `_SubpixelUpConvBN`): the same checkpoints, the
    # same outputs up to summation order, fewer MACs. Inference only. Not a
    # fast option on the H100: there the ball sub-step runs slower than
    # with the dense model (its up-part sum and BN run outside K1; PERF.md).
    subpixel_up: bool = False
    # 1: the reference's stride-1 rolling ensemble. seq_len: each window
    # evaluated once (about seq_len times less TrackNet work, no temporal
    # ensemble; an opt-in trade with no reference equivalent).
    window_stride: int = 1
    load_path: Optional[str] = None
    save_path: Optional[str] = None


@dataclass
class PipelineConfig:
    """End-to-end pipeline configuration."""

    input_video_path: str = "./examples/videos/rally.mp4"
    output_video_path: str = "results.mp4"
    collect_data: bool = True
    collect_data_path: str = "data.csv"
    max_frames: Optional[int] = None
    # False: no annotated video; data.csv is still collected.
    render_video: bool = True
    # Encode the annotated video at this fraction of the source size.
    render_scale: float = 1.0
    fixed_court_keypoints_load_path: Optional[str] = None
    fixed_court_keypoints_save_path: Optional[str] = None
    players: PlayersTrackerConfig = field(default_factory=PlayersTrackerConfig)
    player_keypoints: PlayerKeypointsTrackerConfig = field(
        default_factory=PlayerKeypointsTrackerConfig
    )
    court_keypoints: CourtKeypointsTrackerConfig = field(
        default_factory=CourtKeypointsTrackerConfig
    )
    ball: BallTrackerConfig = field(default_factory=BallTrackerConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)

    @classmethod
    def from_flat(cls, flat: Mapping[str, Any]) -> "PipelineConfig":
        """Build from the reference's flat config names; unknown keys are
        ignored so a user's existing config module works as-is."""
        get = flat.get
        cfg = cls(
            input_video_path=get("INPUT_VIDEO_PATH", cls.input_video_path),
            output_video_path=get("OUTPUT_VIDEO_PATH", cls.output_video_path),
            collect_data=get("COLLECT_DATA", True),
            collect_data_path=get("COLLECT_DATA_PATH", "data.csv"),
            max_frames=get("MAX_FRAMES"),
            render_video=get("RENDER_VIDEO", True),
            render_scale=get("RENDER_SCALE", 1.0),
            fixed_court_keypoints_load_path=get("FIXED_COURT_KEYPOINTS_LOAD_PATH"),
            fixed_court_keypoints_save_path=get("FIXED_COURT_KEYPOINTS_SAVE_PATH"),
        )
        cfg.players = PlayersTrackerConfig(
            model_path=get("PLAYERS_TRACKER_MODEL"),
            batch_size=get("PLAYERS_TRACKER_BATCH_SIZE", 8),
            annotator=get("PLAYERS_TRACKER_ANNOTATOR", "rectangle_bounding_box"),
            load_path=get("PLAYERS_TRACKER_LOAD_PATH"),
            save_path=get("PLAYERS_TRACKER_SAVE_PATH"),
        )
        cfg.player_keypoints = PlayerKeypointsTrackerConfig(
            model_path=get("PLAYERS_KEYPOINTS_TRACKER_MODEL"),
            train_image_size=get("PLAYERS_KEYPOINTS_TRACKER_TRAIN_IMAGE_SIZE", 1280),
            batch_size=get("PLAYERS_KEYPOINTS_TRACKER_BATCH_SIZE", 8),
            load_path=get("PLAYERS_KEYPOINTS_TRACKER_LOAD_PATH"),
            save_path=get("PLAYERS_KEYPOINTS_TRACKER_SAVE_PATH"),
        )
        cfg.court_keypoints = CourtKeypointsTrackerConfig(
            model_path=get("KEYPOINTS_TRACKER_MODEL"),
            batch_size=get("KEYPOINTS_TRACKER_BATCH_SIZE", 8),
            model_type=get("KEYPOINTS_TRACKER_MODEL_TYPE", "yolo"),
            load_path=get("KEYPOINTS_TRACKER_LOAD_PATH"),
            save_path=get("KEYPOINTS_TRACKER_SAVE_PATH"),
        )
        cfg.ball = BallTrackerConfig(
            tracking_model_path=get("BALL_TRACKER_MODEL"),
            inpainting_model_path=get("BALL_TRACKER_INPAINT_MODEL"),
            batch_size=get("BALL_TRACKER_BATCH_SIZE", 8),
            median_max_sample_num=get("BALL_TRACKER_MEDIAN_MAX_SAMPLE_NUM", 400),
            load_path=get("BALL_TRACKER_LOAD_PATH"),
            save_path=get("BALL_TRACKER_SAVE_PATH"),
        )
        return cfg

    @classmethod
    def from_module(cls, module) -> "PipelineConfig":
        """Build from an imported reference-style config module."""
        return cls.from_flat({k: v for k, v in vars(module).items() if k.isupper()})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
