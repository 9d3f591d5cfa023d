"""Typed configuration for the ported ball-tracking path.

Counterpart of ``padel_analytics_tpu/config.py``: the `BallTrackerConfig`
and the `PipelineConfig` fields the ported path reads. `from_flat` /
`from_module` accept the reference's flat config names. The JAX package's
``use_pallas`` switch has no counterpart: on CUDA the hand-written kernels
are the path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional


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
    eval_mode: str = "weight"  # temporal ensemble weighting
    load_path: Optional[str] = None
    save_path: Optional[str] = None


@dataclass
class PipelineConfig:
    """End-to-end pipeline configuration (the fields the ported path reads)."""

    input_video_path: str = "./examples/videos/rally.mp4"
    output_video_path: str = "results.mp4"
    collect_data: bool = True
    collect_data_path: str = "data.csv"
    max_frames: Optional[int] = None
    render_video: bool = True
    ball: BallTrackerConfig = field(default_factory=BallTrackerConfig)

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
