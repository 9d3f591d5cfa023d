"""Ball tracker: TrackNet sliding-window heatmaps + temporal ensemble +
heatmap decode, on the single-device streaming path.

Counterpart of ``padel_analytics_tpu/trackers/ball.py``, with the
reference's behaviour:

- 512x288 input, seq_len 8, stride-1 sliding windows, median background
  over the first <= median_max_sample_num frames;
- triangular temporal ensemble with uniform head/tail averaging;
- heatmap -> coordinate decode with cv2-contour semantics (kernel K2 on
  CUDA), every stride-1 3x3 ConvBN of TrackNet through kernel K1 on CUDA;
- zero-fill for clips shorter than one window.

Replicated quirk (flag-controlled): the reference double-converts its
median-buffer frames BGR<->RGB, so the first `median_range` frames reach
TrackNet channel-swapped relative to the rest. `channel_quirk=True`
(default) reproduces this for cache-level parity.

Each decoded frame is resized once on the device; windows are assembled on
the device from a carried frame context; TrackNet, the rolling ensemble
(carried heatmap buffer) and the decode run per chunk of frames, so only
(x, y, visibility) come back to the host. Not ported yet: InpaintNet, the
multi-device path and window_stride=seq_len.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Iterable, Optional, Type

import numpy as np
import torch

from ..config import BallTrackerConfig
from ..models.convert import convert_tracknet_checkpoint, load_torch_checkpoint
from ..models.layers import lecun_normal_
from ..models.tracknet import make_tracknet
from ..ops.ensemble import get_ensemble_weight
from ..ops.heatmap import decode_heatmaps
from ..ops.median import median_background
from ._ballwindow import (
    assemble_windows,
    frame_channels,
    make_frame_preprocess,
    median_model_resolution,
)
from ._engine import Engine, pad_batch
from .base import Tracker
from .objects import Ball, TrackedObject


class BallTracker(Tracker):
    """Tracker of the ball object."""

    EVAL_MODE: str = "weight"
    TRAJECTORY_LENGTH: int = 8
    HEIGHT: int = 288
    WIDTH: int = 512
    #: Source frames uploaded and resized per device call.
    RESIZE_CHUNK: int = 32

    def __init__(
        self,
        tracking_model_path: Optional[str],
        inpainting_model_path: Optional[str] = None,
        batch_size: int = 8,
        median_max_sample_num: int = 400,
        median: Optional[np.ndarray] = None,
        load_path: Optional[str | Path] = None,
        save_path: Optional[str | Path] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        channel_quirk: bool = True,
        config: Optional[BallTrackerConfig] = None,
        device: torch.device | str = "cpu",
        seed: int = 0,
    ):
        super().__init__(load_path=load_path, save_path=save_path)
        self.bg_mode = "concat"
        if config is not None:
            tracking_model_path = config.tracking_model_path or tracking_model_path
            inpainting_model_path = config.inpainting_model_path or inpainting_model_path
            batch_size = config.batch_size
            median_max_sample_num = config.median_max_sample_num
            self.HEIGHT = config.height
            self.WIDTH = config.width
            self.EVAL_MODE = config.eval_mode
            self.TRAJECTORY_LENGTH = config.seq_len
            self.bg_mode = config.bg_mode
        if inpainting_model_path:
            raise NotImplementedError(
                "InpaintNet is not ported yet (ROADMAP.md Queue 1: InpaintNet)"
            )

        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.batch_size = batch_size
        self.median_max_sample_num = median_max_sample_num
        self.median = median
        # User-supplied medians are never recomputed; medians computed here
        # are keyed to the clip by a first-frame fingerprint, so reusing the
        # tracker on another clip rebuilds them (ensure_median_for_clip).
        self._median_user = median is not None
        self._median_fp: Optional[str] = None
        self.channel_quirk = channel_quirk

        self.tracknet_seq_len = self.TRAJECTORY_LENGTH
        state_dict = None
        if tracking_model_path is not None:
            if not str(tracking_model_path).endswith((".pt", ".pth")):
                raise ValueError(f"unsupported TrackNet checkpoint {tracking_model_path!r}")
            state_dict, param_dict = convert_tracknet_checkpoint(
                load_torch_checkpoint(str(tracking_model_path))
            )
            self.tracknet_seq_len = int(param_dict.get("seq_len", self.TRAJECTORY_LENGTH))
            self.bg_mode = param_dict.get("bg_mode", "concat")
            if self.tracknet_seq_len != self.TRAJECTORY_LENGTH:
                raise ValueError(
                    f"checkpoint seq_len {self.tracknet_seq_len} != {self.TRAJECTORY_LENGTH}"
                )
        if self.bg_mode not in ("", "subtract", "subtract_concat", "concat"):
            raise ValueError(f"unknown bg_mode {self.bg_mode!r}")
        model, self.tracknet_in_dim = make_tracknet(self.tracknet_seq_len, self.bg_mode)
        if state_dict is None:
            lecun_normal_(model, torch.Generator().manual_seed(seed))
        self.tracknet = Engine(model, self.device, state_dict)

    def video_info_post_init(self, video_info) -> "BallTracker":
        self.video_info = video_info
        return self

    def object(self) -> Type[TrackedObject]:
        return Ball

    def __str__(self) -> str:
        return "ball_tracker"

    # ------------------------------------------------------------------

    def _window_step(self, frames_u8, median_u8, frame_carry, carry, coef):
        """One chunk step: window assembly (carried frame context) ->
        TrackNet -> rolling ensemble (carried heatmap buffer) -> decode.

        Chunk k holds frames [kB, kB+B); the windows completed by it are
        those ENDING in the chunk, and the frames emitted are
        f = kB-(L-1)+j for j in [0, B): buffer row j+r always maps to window
        kB-2(L-1)+j+r, so padded windows are neutralised by their zero
        coefficients. frames_u8: (B, H, W, C_f); frame_carry: (L-1, H, W,
        C_f) fp32; carry: (L-1, L, H, W) fp32; coef: (B, L)."""
        seq_len = self.tracknet_seq_len
        b = frames_u8.shape[0]
        frames_ext = torch.cat([frame_carry, frames_u8.float()], dim=0)
        x = assemble_windows(frames_ext, median_u8, self.bg_mode, seq_len, b)
        y = self.tracknet.model(x.to(self.compute_dtype))  # (b, H, W, L)
        y = y.permute(0, 3, 1, 2).float()  # (b, L, H, W)
        buf = torch.cat([carry, y], dim=0)  # (b + L - 1, L, H, W)
        # out[f] = sum_j coef[f, j] * buf[f + j, L-1-j], summed in j order.
        ens = sum(
            coef[:, j, None, None] * buf[j: j + b, seq_len - 1 - j]
            for j in range(seq_len)
        )
        cx, cy, vis = decode_heatmaps(ens)
        return cx, cy, vis, frames_ext[-(seq_len - 1):], buf[-(seq_len - 1):]

    # ------------------------------------------------------------------

    def predict_frames(self, frame_generator: Iterable[np.ndarray], total_frames: int,
                       **kwargs) -> list[Ball]:
        w_scaler = self.video_info.width / self.WIDTH
        h_scaler = self.video_info.height / self.HEIGHT
        with torch.inference_mode():
            stream = self._resized_frame_stream(frame_generator)
            xs, ys, vs, video_len = self._window_loop(stream)
        if total_frames and video_len != total_frames:
            print(f"{self}: decoded {video_len} frames, expected {total_frames}")
        return self._finish_predictions(xs, ys, vs, video_len, w_scaler, h_scaler)

    def _finish_predictions(self, xs, ys, vs, video_len, w_scaler, h_scaler) -> list[Ball]:
        if video_len < self.tracknet_seq_len:
            return [Ball(frame=i, xy=(0.0, 0.0), visibility=0) for i in range(video_len)]
        # Heatmap coords to source pixels, with int truncation at both steps.
        xs = [int(int(x) * w_scaler) for x in xs]
        ys = [int(int(y) * h_scaler) for y in ys]
        return [
            Ball(frame=i, xy=(float(xs[i]), float(ys[i])), visibility=int(vs[i]))
            for i in range(video_len)
        ]

    def _coef_row(self, f: int, video_len: Optional[int]) -> np.ndarray:
        """One row of the overlap-ensemble coefficient table. `video_len`
        may be None while the clip is still streaming; then `f` is a head
        or body frame, whose row does not depend on the clip length."""
        seq_len = self.tracknet_seq_len
        row = np.zeros(seq_len, np.float32)
        if video_len is not None:
            num_windows = video_len - seq_len + 1
            valid = np.array(
                [0 <= f - (seq_len - 1) + j < num_windows for j in range(seq_len)]
            )
            if f > num_windows - 1:
                # The reference's tail quirk (see overlap_ensemble_coefficients).
                row[valid] = 1.0 / (num_windows + seq_len - 1 - f)
            elif f < seq_len - 1:
                row[valid] = 1.0 / valid.sum()
            else:
                row[:] = get_ensemble_weight(seq_len, self.EVAL_MODE)
        elif f < seq_len - 1:
            for j in range(seq_len):
                if f - (seq_len - 1) + j >= 0:
                    row[j] = 1.0 / (f + 1)
        else:
            row[:] = get_ensemble_weight(seq_len, self.EVAL_MODE)
        return row

    def _window_loop(self, resized_iter):
        """Chunked TrackNet + ensemble + decode over an iterator of resized
        frames (device tensors).

        The clip is zero-extended by seq_len-1 frames so that every output
        frame (head, body and tail) is emitted by one uniform chunk loop;
        windows touching the padding get coefficient 0.

        Returns (xs, ys, vs, video_len). Requires `self._median_resized`
        to be set by the iterator before (or at) its first yield."""
        seq_len = self.tracknet_seq_len
        chunk = max(self.batch_size, 1)
        video_len: Optional[int] = None
        n_read = 0

        def pull():
            nonlocal video_len, n_read
            try:
                f = next(resized_iter)
                n_read += 1
                return f
            except StopIteration:
                if video_len is None:
                    video_len = n_read
                return None

        first = pull()
        if first is None:
            return [], [], [], 0
        pending: list[torch.Tensor] = [first]
        dev = first.device
        carry = torch.zeros((seq_len - 1, seq_len, self.HEIGHT, self.WIDTH),
                            dtype=torch.float32, device=dev)
        frame_carry = torch.zeros(
            (seq_len - 1, self.HEIGHT, self.WIDTH, frame_channels(self.bg_mode)),
            dtype=torch.float32, device=dev,
        )
        median_dev = torch.from_numpy(self._median_resized).to(dev)

        xs: list[int] = []
        ys: list[int] = []
        vs: list[int] = []
        lo = 0
        while True:
            while len(pending) < chunk and video_len is None:
                nxt = pull()
                if nxt is None:
                    break
                pending.append(nxt)
            if video_len is not None:
                if video_len < seq_len:
                    return [], [], [], video_len
                if lo >= video_len + seq_len - 1:
                    break
            frames = pending[:chunk]
            pending = pending[chunk:]
            arr = torch.stack(frames) if frames else first.new_zeros((0,) + tuple(first.shape))
            arr, _ = pad_batch(arr, chunk)
            emit_lo = lo - (seq_len - 1)
            coef_chunk = np.zeros((chunk, seq_len), np.float32)
            for j in range(chunk):
                f = emit_lo + j
                if f >= 0 and (video_len is None or f < video_len):
                    coef_chunk[j] = self._coef_row(f, video_len)
            cx, cy, vis, frame_carry, carry = self._window_step(
                arr, median_dev, frame_carry, carry, torch.from_numpy(coef_chunk).to(dev)
            )
            out = torch.stack([cx, cy, vis]).cpu().numpy()
            for j in range(chunk):
                f = emit_lo + j
                if f >= 0 and (video_len is None or f < video_len):
                    xs.append(int(out[0, j]))
                    ys.append(int(out[1, j]))
                    vs.append(int(out[2, j]))
            lo += chunk

        if len(xs) != video_len:
            raise RuntimeError(f"emitted {len(xs)} frames for a {video_len}-frame clip")
        return xs, ys, vs, video_len

    # ------------------------------------------------------------------

    def owns_median(self) -> bool:
        """True when this tracker computes (and may recompute) the median
        itself: a background mode is active and no median was supplied."""
        return bool(self.bg_mode) and not self._median_user

    def ensure_median_for_clip(self, head_frames: list[np.ndarray]) -> bool:
        """(Re)compute the median from the clip's buffered head unless a
        cached one already belongs to this clip (first-frame fingerprint).
        Returns True iff the reference's median-buffer channel quirk applies
        to the head frames this run."""
        if not self.owns_median():
            raise RuntimeError("the median was supplied by the caller")
        subtract_mode = self.bg_mode in ("subtract", "subtract_concat")
        fp = hashlib.sha1(head_frames[0].tobytes()).hexdigest()
        if self.median is None or fp != self._median_fp:
            self.median = median_background(
                np.stack(head_frames), exact=subtract_mode, device=self.device
            )
            self._median_fp = fp
        return self.channel_quirk

    def _resized_frame_stream(self, frame_generator):
        """Decode -> (median over the head of the clip) -> device resize to
        (HEIGHT, WIDTH) uint8, yielded frame by frame as device tensors.

        Sets `self._median_resized` before the first yield. Peak residency:
        the median head buffer (<= median_max_sample_num source frames, as
        the reference buffers) while it drains, then RESIZE_CHUNK frames."""
        chunk = self.RESIZE_CHUNK
        subtract_mode = self.bg_mode in ("subtract", "subtract_concat")
        median_src_dev = None
        pre = None

        def flush(frames: list[np.ndarray], swapped: bool):
            nonlocal pre
            if not frames:
                return
            arr = np.stack(frames)
            if pre is None:
                pre = make_frame_preprocess(arr.shape[1:3], (self.HEIGHT, self.WIDTH),
                                            self.bg_mode)
            x = torch.from_numpy(arr).to(self.device)
            # Reference double-conversion quirk: median-buffer frames reach
            # the net channel-swapped; for the subtract modes the swap comes
            # before the |frame - median| difference, as in the reference.
            # The swap runs on the device: a host [..., ::-1] copy of 1080p
            # frames cost more than the rest of the pass together.
            if swapped and self.channel_quirk:
                x = x.flip(-1)
            out = pre(x, median_src=median_src_dev) if subtract_mode else pre(x)
            yield from out.to(torch.uint8)

        if self.owns_median():
            buffered: list[np.ndarray] = []
            gen = iter(frame_generator)
            for frame in gen:
                buffered.append(frame)
                if len(buffered) == self.median_max_sample_num:
                    break
            if not buffered:
                self._set_median_resized()
                return
            # Exact float median for the subtract modes, truncated uint8 for
            # 'concat'; the quirk swap applies to the head frames either way.
            quirk = self.ensure_median_for_clip(buffered)
            if subtract_mode:
                median_src_dev = torch.from_numpy(self.median.astype(np.float32)).to(self.device)
            self._set_median_resized()
            for i in range(0, len(buffered), chunk):
                yield from flush(buffered[i: i + chunk], swapped=quirk)
            buffered = []
            rest: Iterable[np.ndarray] = gen
        else:
            if subtract_mode:
                if self.median is None:
                    raise ValueError(f"bg_mode={self.bg_mode!r} needs a median background")
                median_src_dev = torch.from_numpy(self.median.astype(np.float32)).to(self.device)
            self._set_median_resized()
            rest = frame_generator
        tail: list[np.ndarray] = []
        for frame in rest:
            tail.append(frame)
            if len(tail) == chunk:
                yield from flush(tail, swapped=False)
                tail = []
        yield from flush(tail, swapped=False)

    def _set_median_resized(self) -> None:
        # Median at model resolution, or a zeros placeholder (other modes,
        # or an empty clip with no median).
        if self.median is None:
            self._median_resized = np.zeros((self.HEIGHT, self.WIDTH, 3), np.uint8)
            return
        self._median_resized = median_model_resolution(
            self.median, self.HEIGHT, self.WIDTH, self.bg_mode, self.device
        )
