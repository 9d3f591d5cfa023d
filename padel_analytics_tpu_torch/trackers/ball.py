"""Ball tracker: TrackNet sliding-window heatmaps + temporal ensemble +
heatmap decode, on the single-device streaming path.

Counterpart of ``padel_analytics_tpu/trackers/ball.py``, with the
reference's behaviour:

- 512x288 input, seq_len 8, stride-1 sliding windows, median background
  over the first <= median_max_sample_num frames (or, with
  `window_stride=seq_len`, each window evaluated once: no ensemble, no lag,
  the last partial window zero-padded; an opt-in fast mode);
- triangular temporal ensemble with uniform head/tail averaging;
- heatmap -> coordinate decode with cv2-contour semantics (kernel K2 on
  CUDA), every stride-1 3x3 ConvBN of TrackNet through kernel K1 on CUDA;
- with an InpaintNet checkpoint, the trajectory's gaps filled: the inpaint
  mask (`generate_inpaint_mask`, host numpy), InpaintNet over every
  seq_len-frame window of normalised coordinates, the blend, the COOR_TH
  clamps and InpaintNet's own overlap ensemble, all on the tracker's device
  (`_inpaint_pass`);
- zero-fill for clips shorter than one window.

Replicated quirk (flag-controlled): the reference double-converts its
median-buffer frames BGR<->RGB, so the first `median_range` frames reach
TrackNet channel-swapped relative to the rest. `channel_quirk=True`
(default) reproduces this for cache-level parity.

Each decoded frame is resized once on the device; windows are assembled on
the device from a carried frame context; TrackNet, the rolling ensemble
(carried heatmap buffer) and the decode run per chunk of frames, so only
(x, y, visibility) come back to the host. With a `mesh` (parallel/mesh.py,
one process a device) every rank resizes the whole clip, and the window pass
splits its frame axis over the ranks with a seq_len-1 halo exchange
(parallel/sharded_inference.py); every rank returns the whole clip's balls.
"""

from __future__ import annotations

import hashlib
import math
from pathlib import Path
from typing import Iterable, Optional, Sequence, Type

import numpy as np
import torch

from ..config import BallTrackerConfig
from ..core.checkpoint import checkpoint_format
from ..models.convert import (
    convert_inpaintnet_checkpoint,
    convert_tracknet_checkpoint,
    load_flax_state_dict,
    load_torch_checkpoint,
)
from ..models.layers import lecun_normal_
from ..models.tracknet import InpaintNet, make_tracknet
from ..ops.ensemble import get_ensemble_weight, overlap_ensemble_coefficients
from ..ops.heatmap import decode_heatmaps
from ..ops.median import median_on_device
from ..parallel.sharded_inference import sharded_window_inference
from ._ballwindow import (
    assemble_windows,
    frame_channels,
    make_frame_preprocess,
    median_model_resolution,
)
from ._engine import Engine, pad_batch
from .base import Tracker
from .objects import Ball, TrackedObject


def _check_tracknet_shapes(path: str, state_dict, model, seq_len: int, bg_mode: str) -> None:
    """Raise where the weights are not the TrackNet of (seq_len, bg_mode):
    the first conv's input channels and the last conv's outputs first (they
    name the two), then every other shape."""
    want = model.state_dict()
    names = [k for k in want if k.endswith(".weight") and want[k].ndim == 4]
    for key in (names[0], names[-1], *want):
        if key in state_dict and tuple(state_dict[key].shape) != tuple(want[key].shape):
            raise ValueError(
                f"{path}: {key} has shape {tuple(state_dict[key].shape)}, the TrackNet of "
                f"seq_len={seq_len}, bg_mode={bg_mode!r} wants {tuple(want[key].shape)} "
                "(a .msgpack carries no param_dict: set BallTrackerConfig's seq_len and "
                "bg_mode to the weights')")


def generate_inpaint_mask(pred_dict: dict, th_h: float = 30) -> list:
    """The reference's mask of trajectory gaps to inpaint: a run of invisible
    frames is inpainted only when the ball was low (y > th_h) on both sides
    of the gap; otherwise it left the camera's view."""
    y = np.array(pred_dict["y"])
    vis = np.array(pred_dict["visibility"])
    mask = np.zeros_like(y)
    n = len(vis)
    i = j = 0
    while j < n:
        while i < n - 1 and vis[i] == 1:
            i += 1
        j = i
        while j < n - 1 and vis[j] == 0:
            j += 1
        if j == i:
            break
        elif i == 0 and y[j] > th_h:
            mask[:j] = 1
        elif (i > 1 and y[i - 1] > th_h) and (j < n and y[j] > th_h):
            mask[i:j] = 1
        i = j
    return mask.tolist()


class BallTracker(Tracker):
    """Tracker of the ball object."""

    EVAL_MODE: str = "weight"
    TRAJECTORY_LENGTH: int = 8
    HEIGHT: int = 288
    WIDTH: int = 512
    #: The radius of the training labels' discs (`BallTrackerConfig.sigma`);
    #: inference does not read it.
    SIGMA: float = 2.5
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
        use_inpaintnet: bool = True,
        config: Optional[BallTrackerConfig] = None,
        device: torch.device | str = "cuda",
        seed: int = 0,
        mesh=None,
    ):
        super().__init__(load_path=load_path, save_path=save_path)
        # A parallel.mesh.Mesh: the window pass shards the clip's frames over
        # its ranks. None: this device alone.
        self.mesh = mesh
        self.bg_mode = "concat"
        self.subpixel_up = False
        self.window_stride = 1
        if config is not None:
            tracking_model_path = config.tracking_model_path or tracking_model_path
            inpainting_model_path = config.inpainting_model_path or inpainting_model_path
            batch_size = config.batch_size
            median_max_sample_num = config.median_max_sample_num
            self.HEIGHT = config.height
            self.WIDTH = config.width
            self.SIGMA = config.sigma
            self.EVAL_MODE = config.eval_mode
            self.TRAJECTORY_LENGTH = config.seq_len
            self.bg_mode = config.bg_mode
            self.subpixel_up = config.subpixel_up
            if config.window_stride not in (1, config.seq_len):
                raise ValueError(f"window_stride must be 1 or seq_len={config.seq_len}, "
                                 f"got {config.window_stride}")
            self.window_stride = config.window_stride
        # The inpaint pass's clamp: 50 heatmap-diagonal units.
        self.DELTA_T = 1 / math.sqrt(self.HEIGHT ** 2 + self.WIDTH ** 2)
        self.COOR_TH = self.DELTA_T * 50

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
        # `median` on the device, beside the array it holds: the tensor the
        # median was computed as, or one upload of a median set from outside.
        self._median_dev: tuple[Optional[np.ndarray], Optional[torch.Tensor]] = (None, None)
        self.channel_quirk = channel_quirk

        self.tracknet_seq_len = self.TRAJECTORY_LENGTH
        state_dict = None
        path = None if tracking_model_path is None else str(tracking_model_path)
        if path is not None and checkpoint_format(path, "TrackNet checkpoint") != "torch":
            # A Flax tree (.msgpack or orbax) carries no param_dict: seq_len
            # and bg_mode are the config's, checked against the weights'
            # shapes below.
            state_dict = load_flax_state_dict(path)
        elif path is not None:
            state_dict, param_dict = convert_tracknet_checkpoint(load_torch_checkpoint(path))
            self.tracknet_seq_len = int(param_dict.get("seq_len", self.TRAJECTORY_LENGTH))
            self.bg_mode = param_dict.get("bg_mode", "concat")
            if self.tracknet_seq_len != self.TRAJECTORY_LENGTH:
                raise ValueError(
                    f"checkpoint seq_len {self.tracknet_seq_len} != {self.TRAJECTORY_LENGTH}"
                )
        if self.bg_mode not in ("", "subtract", "subtract_concat", "concat"):
            raise ValueError(f"unknown bg_mode {self.bg_mode!r}")
        model, self.tracknet_in_dim = make_tracknet(self.tracknet_seq_len, self.bg_mode,
                                                    self.subpixel_up)
        if state_dict is None:
            lecun_normal_(model, torch.Generator().manual_seed(seed))
        else:
            _check_tracknet_shapes(path, state_dict, model, self.tracknet_seq_len, self.bg_mode)
        self.tracknet = Engine(model, self.device, state_dict)

        # InpaintNet, from a reference checkpoint (tensors and plain values
        # only, loaded without unpickling code), unless `use_inpaintnet` is
        # False: then nothing is loaded and the trajectory keeps its gaps.
        self.inpaintnet: Optional[Engine] = None
        self.inpaintnet_seq_len = 16
        if inpainting_model_path and use_inpaintnet:
            ipath = str(inpainting_model_path)
            if checkpoint_format(ipath, "InpaintNet checkpoint") == "torch":
                istate, iparams = convert_inpaintnet_checkpoint(load_torch_checkpoint(ipath))
            else:
                istate, iparams = load_flax_state_dict(ipath), {}
            self.inpaintnet_seq_len = int(iparams.get("seq_len", 16))
            self.inpaintnet = Engine(InpaintNet(), self.device, istate)

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

    def _nonoverlap_step(self, frames_u8, median_u8):
        """One chunk in the nonoverlap mode (window_stride = seq_len): the
        chunk's B frames (B a multiple of seq_len) form B / seq_len disjoint
        windows, each run once; window i's output channel j is frame
        i * seq_len + j's heatmap. No ensemble, no carry. Returns (cx, cy,
        vis), one row a frame."""
        seq_len = self.tracknet_seq_len
        b = frames_u8.shape[0]
        nwin = b // seq_len
        fr = frames_u8.float().reshape((nwin, seq_len) + tuple(frames_u8.shape[1:]))
        parts = [fr[:, j] for j in range(seq_len)]
        if self.bg_mode == "concat":
            parts = [median_u8.float()[None].expand((nwin,) + tuple(median_u8.shape))] + parts
        x = torch.cat(parts, dim=-1) / 255.0
        y = self.tracknet.model(x.to(self.compute_dtype))  # (nwin, H, W, L)
        heat = y.permute(0, 3, 1, 2).float().reshape((b,) + tuple(y.shape[1:3]))
        return decode_heatmaps(heat)

    # ------------------------------------------------------------------

    def predict_frames(self, frame_generator: Iterable[np.ndarray], total_frames: int,
                       **kwargs) -> list[Ball]:
        w_scaler = self.video_info.width / self.WIDTH
        h_scaler = self.video_info.height / self.HEIGHT
        with torch.inference_mode():
            stream = self._resized_frame_stream(frame_generator)
            if self.mesh is None:
                xs, ys, vs, video_len = self._window_loop(stream)
            else:
                xs, ys, vs, video_len = self._mesh_window_pass(list(stream))
        if total_frames and video_len != total_frames:
            print(f"{self}: decoded {video_len} frames, expected {total_frames}")
        return self._finish_predictions(xs, ys, vs, video_len, w_scaler, h_scaler)

    def _mesh_window_pass(self, resized: list[torch.Tensor]):
        """The window pass over the whole clip's resized frames with the
        frame axis split over the mesh (windows in batches of batch_size);
        the single-device loop where the clip is too short for the mesh's
        halo. Returns (xs, ys, vs, video_len)."""
        seq_len, d = self.tracknet_seq_len, self.mesh.size
        video_len = len(resized)
        if video_len < seq_len:
            return [], [], [], video_len
        if -(-video_len // d) < seq_len - 1:
            print(f"{self}: clip too short for {d}-way frame sharding (shard < halo); using the "
                  "single-device path")
            return self._window_loop(iter(resized))

        def apply(x):
            return self.tracknet.model(x.to(self.compute_dtype))

        cx, cy, vis = sharded_window_inference(
            apply, torch.stack(resized), self._median_resized, self.mesh, seq_len=seq_len,
            eval_mode=self.EVAL_MODE, bg_mode=self.bg_mode, stride=self.window_stride,
            batch=self.batch_size)
        return cx.tolist(), cy.tolist(), vis.tolist(), video_len

    def _finish_predictions(self, xs, ys, vs, video_len, w_scaler, h_scaler) -> list[Ball]:
        if video_len < self.tracknet_seq_len:
            return [Ball(frame=i, xy=(0.0, 0.0), visibility=0) for i in range(video_len)]
        # Heatmap coords to source pixels, with int truncation at both steps.
        pred = {
            "x": [int(int(x) * w_scaler) for x in xs],
            "y": [int(int(y) * h_scaler) for y in ys],
            "visibility": [int(v) for v in vs],
        }
        return self.balls(pred, video_len)

    def balls(self, pred: dict, video_len: int) -> list[Ball]:
        """Ball objects of a prediction dict ({'x', 'y', 'visibility'} lists,
        source pixels), after the inpaint pass when there is an InpaintNet."""
        if self.inpaintnet is not None:
            pred = self._inpaint_pass(pred, video_len)
        return [
            Ball(frame=i, xy=(float(pred["x"][i]), float(pred["y"][i])),
                 visibility=int(pred["visibility"][i]))
            for i in range(video_len)
        ]

    def _inpaint_pass(self, pred: dict, video_len: int) -> dict:
        """InpaintNet gap filling and its own overlap ensemble
        (`inpaint_ensemble`), then the coordinates back to source pixels. A
        clip shorter than the InpaintNet window returns `pred` as it was."""
        ens = self.inpaint_ensemble(pred, video_len)
        if ens is None:
            return pred
        h, w = self.video_info.height, self.video_info.width
        # Denormalised in the reference's float order, int(c * WIDTH *
        # (w / WIDTH)), not int(c * w): the two differ by 1 at truncation
        # boundaries.
        w_scaler = w / self.WIDTH
        h_scaler = h / self.HEIGHT
        xs = [int(v * self.WIDTH * w_scaler) for v in ens[:, 0]]
        ys = [int(v * self.HEIGHT * h_scaler) for v in ens[:, 1]]
        vis = [0 if (x == 0 and y == 0) else 1 for x, y in zip(xs, ys)]
        return {"frame": list(range(video_len)), "x": xs, "y": ys, "visibility": vis}

    def inpaint_ensemble(self, pred: dict, video_len: int) -> Optional[np.ndarray]:
        """(video_len, 2) fp32 normalised coordinates after InpaintNet, the
        blend, the COOR_TH clamps and the overlap ensemble, computed on the
        tracker's device in one call over every window of the clip; None for
        a clip shorter than the window L.

        Window w holds frames [w, w + L); frame f's ensemble is
        sum_j coef[f, j] * blended[f - (L-1) + j, (L-1) - j], summed in j
        order (the JAX package's order; it ran the windows in chunks of 64
        only so that XLA compiles once), with windows outside [0, N_w)
        zero."""
        seq_len = self.inpaintnet_seq_len
        h, w = self.video_info.height, self.video_info.width
        mask_list = generate_inpaint_mask(pred, th_h=h * 0.05)
        if video_len < seq_len:
            return None
        # Normalised by the source's size, on the host in fp32 as the
        # reference's dataset does.
        coords = np.stack([np.asarray(pred["x"], np.float32) / w,
                           np.asarray(pred["y"], np.float32) / h], axis=-1)
        mask = np.asarray(mask_list, np.float32)
        coef = overlap_ensemble_coefficients(video_len, seq_len, self.EVAL_MODE)
        dev = self.device
        num_windows = video_len - seq_len + 1
        coor_th = self.COOR_TH
        with torch.inference_mode():
            coords_d, mask_d, coef_d = (torch.from_numpy(a).to(dev) for a in (coords, mask, coef))
            idx = (torch.arange(num_windows, device=dev)[:, None]
                   + torch.arange(seq_len, device=dev)[None, :])
            wc, wm = coords_d[idx], mask_d[idx][..., None]  # (N_w, L, 2), (N_w, L, 1)
            out = self.inpaintnet.model(wc, wm, self.compute_dtype)
            blended = out * wm + wc * (1.0 - wm)
            th = (blended[..., 0] < coor_th) & (blended[..., 1] < coor_th)
            blended = torch.where(th[..., None], 0.0, blended)
            # L-1 zero windows before the first and after the last.
            pad = blended.new_zeros((seq_len - 1, seq_len, 2))
            buf = torch.cat([pad, blended, pad], dim=0)  # (video_len + L - 1, L, 2)
            ens = sum(coef_d[:, j, None] * buf[j: j + video_len, seq_len - 1 - j]
                      for j in range(seq_len))
            th2 = (ens[..., 0] < coor_th) & (ens[..., 1] < coor_th)
            return torch.where(th2[..., None], 0.0, ens).cpu().numpy()

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

    def _window_loop_nonoverlap(self, resized_iter):
        """Chunked nonoverlap TrackNet + decode (window_stride = seq_len):
        chunk k emits its own frames, with no lag and no coefficient table;
        the chunk is the batch size rounded up to a multiple of seq_len, and
        the last partial window sees zero frames. Returns (xs, ys, vs,
        video_len)."""
        seq_len = self.tracknet_seq_len
        chunk = -(-max(self.batch_size, 1) // seq_len) * seq_len
        first = next(resized_iter, None)
        if first is None:
            return [], [], [], 0
        median_dev = self._median_resized.to(first.device)
        pending = [first]
        xs: list[int] = []
        ys: list[int] = []
        vs: list[int] = []
        video_len = 0
        exhausted = False
        while pending or not exhausted:
            while len(pending) < chunk and not exhausted:
                nxt = next(resized_iter, None)
                if nxt is None:
                    exhausted = True
                else:
                    pending.append(nxt)
            if not pending:
                break
            frames, pending = pending[:chunk], pending[chunk:]
            arr, _ = pad_batch(torch.stack(frames), chunk)
            out = torch.stack(self._nonoverlap_step(arr, median_dev)).cpu().numpy()
            xs += out[0, :len(frames)].tolist()
            ys += out[1, :len(frames)].tolist()
            vs += out[2, :len(frames)].tolist()
            video_len += len(frames)
        return xs, ys, vs, video_len

    def _window_loop(self, resized_iter):
        """Chunked TrackNet + ensemble + decode over an iterator of resized
        frames (device tensors); `_window_loop_nonoverlap` where
        window_stride = seq_len.

        The clip is zero-extended by seq_len-1 frames so that every output
        frame (head, body and tail) is emitted by one uniform chunk loop;
        windows touching the padding get coefficient 0.

        Returns (xs, ys, vs, video_len). Requires `self._median_resized`
        to be set by the iterator before (or at) its first yield."""
        if self.window_stride != 1:
            return self._window_loop_nonoverlap(resized_iter)
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
        median_dev = self._median_resized.to(dev)

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

    def ensure_median_for_clip(self, head_frames: Sequence[np.ndarray]) -> bool:
        """(Re)compute the median from the clip's buffered head (a list of
        frames, or their stack) unless a cached one already belongs to this
        clip (first-frame fingerprint). The frames go to the device band by
        band through pinned slots, with no host stack
        (`ops.median.median_on_device`); the median stays there for the
        device steps (`device_median`), and `self.median` is its one
        download. Returns True iff the reference's median-buffer channel
        quirk applies to the head frames this run."""
        if not self.owns_median():
            raise RuntimeError("the median was supplied by the caller")
        subtract_mode = self.bg_mode in ("subtract", "subtract_concat")
        fp = hashlib.sha1(head_frames[0].tobytes()).hexdigest()
        if self.median is None or fp != self._median_fp:
            dev = median_on_device(head_frames, exact=subtract_mode, device=self.device)
            self.median = dev.cpu().numpy()
            self._median_dev = (self.median, dev)
            self._median_fp = fp
        return self.channel_quirk

    def device_median(self) -> torch.Tensor:
        """`self.median` on the tracker's device: the tensor it was computed
        as, or, for a median set from outside, one upload kept while
        `self.median` is the same array."""
        held, dev = self._median_dev
        if held is not self.median:
            dev = torch.from_numpy(np.ascontiguousarray(self.median)).to(self.device)
            self._median_dev = (self.median, dev)
        return dev

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
                median_src_dev = self.device_median().float()
            self._set_median_resized()
            for i in range(0, len(buffered), chunk):
                yield from flush(buffered[i: i + chunk], swapped=quirk)
            buffered = []
            rest: Iterable[np.ndarray] = gen
        else:
            if subtract_mode:
                if self.median is None:
                    raise ValueError(f"bg_mode={self.bg_mode!r} needs a median background")
                median_src_dev = self.device_median().float()
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
        # Median at model resolution on the device, or a zeros placeholder
        # (other modes, or an empty clip with no median).
        if self.median is None:
            self._median_resized = torch.zeros((self.HEIGHT, self.WIDTH, 3), dtype=torch.uint8,
                                               device=self.device)
            return
        self._median_resized = median_model_resolution(
            self.device_median(), self.HEIGHT, self.WIDTH, self.bg_mode, self.device
        )
