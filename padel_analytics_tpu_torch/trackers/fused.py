"""Fused multi-tracker pipeline: one upload per chunk of frames, three or
four sub-steps on their own CUDA streams sharing it.

Counterpart of ``padel_analytics_tpu/trackers/fused.py`` (`FusedPipeline.run`,
`run_staged`, `run_mesh` and `measure_device_split`). The per-tracker runner
pays one decode, one upload and one serial pass per tracker; here each chunk
is decoded once, packed on the host into a reused pinned staging slot (RGB;
I420 at half the bytes; or 'derived': an I420 buffer of the frame
downscaled on the host by an INTER_AREA resize bit-equal to OpenCV's, to a
long side of at most `wire_long_side`, a quarter of the 1080p pixels at
960), copied to the device once, and consumed by:

  frames (B, H, W, 3) uint8 on the device   [one H2D copy, copy stream]
    ├── det  (stream): letterbox -> YOLOv8 -> NMS candidates  ┐ each ends in
    ├── pose (stream): squash -> YOLOv8-pose -> NMS candidates│ ONE packed
    ├── ball (stream): resize + carried 7-frame context ->    │ buffer, one
    │     TrackNet windows -> rolling ensemble -> decode (K2) │ D2H copy
    └── court (stream, a model court only): squash ->         │
          YOLOv8-pose (12 keypoints) -> NMS candidates, or    │
          ResNet-50 -> 12 keypoints                           ┘

Each sub-step reuses its tracker's own device half (`device_step`) and its
results are finished on the host by the tracker's host half (`host_step`:
the greedy NMS pass, unletterbox, clip, polygon gate, keypoint rescale),
then ByteTrack (or, with association='device', the association scan over
the chunk's rows on the host's torch, `ops/association_scan.py`), at the
drain; the court's keypoints are scaled from wire to
source pixels there ('yolo') or on the device ('resnet'). A fixed court
costs nothing. With an InpaintNet the ball tracker's inpaint pass runs over
the whole clip at the end (so the results cannot stream). Up to two chunks
stay in flight: the drain of
chunk k-2 waits on its events while chunks k-1 and k run on the device, and
the next chunk's decode and pack run in a prefetch worker meanwhile. No
step between the upload and the drain synchronises the host: the ensemble
coefficients and the channel-quirk flags live on the device for the whole
run and are sliced by the chunk's first frame.

Every model input is derived on the device from the uploaded (wire)
frames; the det boxes are mapped from wire to source pixels on the host, the
pose keypoints from model space to source pixels directly.

Ball alignment: after chunk k (frames [kB, kB+B)), the windows completed
are those ending inside the chunk, and the frames emitted are
f = kB-(L-1)+j; the clip is zero-extended by L-1 frames so the tail flushes
through the same uniform loop (windows touching padding carry coefficient
0). The caches equal the per-tracker paths' byte for byte
(tests/test_torch_fused.py). With ball_stride=seq_len (nonoverlap) each
window of seq_len chunk frames runs once and the chunk emits its own
frames: no ensemble, no carry, no lag; the last partial window sees zero
frames.

`run_mesh` runs the same sub-steps with the clip's frame axis split over a
mesh of processes, one device each (parallel/mesh.py): each rank uploads its
own chunk of every block of chunk x ranks frames, the packed rows are
all-gathered and drained alike on every rank, and the ball finishes with one
halo-exchange window pass over the gathered preprocessed frames
(parallel/sharded_inference.py).

`run_staged` takes a round of superchunk x chunk frames per upload: one
pinned copy and the decode into one of two round buffers, then one replay a
lane of a CUDA graph that runs the lane's sub-step over every chunk of the
round (trackers/_graphs.py; eager on the CPU), one D2H copy a lane, and
one drain a round. It gives `run`'s results byte for byte.

Every entry point records into the current run of `core.profiling.tracer`
(opening one when called outside a runner): the spans `fused.setup` (with
`ball.median`), `fused.prep_wait`, `fused.pack` (on the prefetch worker),
`fused.dispatch` (with `fused.upload`, and a staged lane's
`fused.capture`), `fused.drain` (with `fused.drain_wait` and
`fused.assoc`) and `fused.finish` (with `ball.inpaint`), once per run, chunk
or round. The prefetch worker's spans join the run it was handed
(`tracer.bind`).
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from ..core.profiling import RunRecord, traced, tracer
from ..models.resnet import imagenet_stats
from ..ops.area import resize_area, resize_area_planes
from ..ops.association_scan import associate_chunk, init_state
from ..ops.color import i420_to_rgb, planes_to_i420, rgb_to_i420
from ..ops.ensemble import overlap_ensemble_coefficients
from ..ops.packing import Layout, pack_rows, unpack_rows
from ..ops.resize import letterbox_plan, resize_plan
from ..parallel.mesh import Mesh
from ..parallel.sharded_inference import sharded_window_inference
from ._ballwindow import frame_channels, make_frame_preprocess, median_model_resolution
from ._graphs import LaneGraph, weights_key
from ._streams import DeviceTimer, Lanes, StagingRing, to_host
from .ball import BallTracker
from .court_keypoints import KeypointsTracker
from .objects import Ball, Player, PlayerKeypoint, PlayerKeypoints, Players, PlayersKeypoints
from .player_keypoints import PlayerKeypointsTracker
from .players import PlayerTracker

#: Threads that pack a chunk's frames into its staging slot (numpy releases
#: the interpreter lock in the copies and the I420 arithmetic).
PACK_THREADS = 4
#: Staging slots: the chunk being uploaded, the one being packed, a spare.
STAGING_SLOTS = 3
#: Chunks in flight on the device before the oldest is drained.
IN_FLIGHT = 2


def _resolved(device: torch.device) -> torch.device:
    """`device` with its index: a bare 'cuda' is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _Scan:
    """The association scan carried through one run, over each drained
    chunk's rows (the host's NMS output) on the host's torch: the scan is a
    few hundred tiny ops a frame, each a launch on the card, where it
    measured slower than here (PERF.md; chip_smoke.py phase 16 times
    both)."""

    device = torch.device("cpu")

    def __init__(self):
        self.state = init_state(device=self.device)
        self.first = True

    def __call__(self, boxes: np.ndarray, scores: np.ndarray, valid: np.ndarray) -> np.ndarray:
        self.state, ids = associate_chunk(self.state, torch.from_numpy(boxes),
                                          torch.from_numpy(scores), torch.from_numpy(valid),
                                          first=self.first)
        self.first = False
        return ids.numpy()


class _FrameWindow:
    """Bounded streaming view over the decoded frame iterator: only the
    frames between the last-dropped and the furthest-filled index are
    resident, so arbitrarily long clips run in O(window) host memory."""

    def __init__(self, initial, it):
        self._win = collections.deque(initial)
        self._base = 0
        self._it = it
        self._exhausted = False

    def fill_to(self, hi: int) -> int:
        """Ensure frames [base, hi) are resident; returns frames available."""
        while not self._exhausted and self._base + len(self._win) < hi:
            nxt = next(self._it, None)
            if nxt is None:
                self._exhausted = True
                break
            self._win.append(nxt)
        return self._base + len(self._win)

    def get(self, i: int):
        return self._win[i - self._base]

    def drop_below(self, i: int) -> None:
        while self._base < i and self._win:
            self._win.popleft()
            self._base += 1

    def first(self):
        return self._win[0]

    def __len__(self):
        return len(self._win)


class _ResultBuilder:
    """Incremental host-side result accumulation at drain time.

    The drain does only host work between dispatches: host ByteTrack
    (inherently sequential; running it here overlaps it with the chunks in
    flight), or the association scan where `scan` is given, and array
    appends. Result objects are built at the emit points only: `maybe_emit`
    for a streaming consumer, `finish` otherwise."""

    def __init__(self, pipeline: "FusedPipeline", n: int, src_hw, stream=None,
                 scan: Optional[_Scan] = None):
        self.pipeline = pipeline
        self.n = n
        ball = pipeline.ball
        self.w_scaler = src_hw[1] / ball.WIDTH
        self.h_scaler = src_hw[0] / ball.HEIGHT
        self._det_chunks: list = []  # (boxes, scores, keep_mask, ids)
        self._pose_chunks: list = []  # (kpts, valid)
        self._court_chunks: list = []  # (kpts, valid)
        self._det_ready = 0
        self._pose_ready = 0
        self._court_ready = 0
        self.players_objs: list[Players] = []
        self.pose_objs: list[PlayersKeypoints] = []
        self.court_objs: list = []
        self.ball_x: list[int] = []
        self.ball_y: list[int] = []
        self.ball_v: list[int] = []
        # The inpaint pass needs the whole clip: nothing streams before it.
        self.stream = stream if ball.inpaintnet is None else None
        self.scan = scan
        self._emitted = 0

    def add_det(self, boxes, scores, valid) -> None:
        """(F, D, 4/-/-) host arrays for F consecutive frames; ByteTrack (or
        the scan) assigns the IDs here, in frame order. A detection the scan
        gives no ID is dropped, as one ByteTrack does not keep."""
        with tracer.span("fused.assoc"):
            if self.scan is not None:
                ids = self.scan(boxes, scores, valid)
                keep_mask = valid & (ids > 0)
            else:
                byte_track = self.pipeline.players.byte_track
                keep_mask = np.zeros(valid.shape, bool)
                ids = np.zeros(valid.shape, np.int64)
                for f in range(boxes.shape[0]):
                    keep = valid[f]
                    ids_f, kept = byte_track.update_with_detections(boxes[f][keep],
                                                                    scores[f][keep])
                    sel = np.flatnonzero(keep)[kept]
                    keep_mask[f, sel] = True
                    ids[f, sel] = ids_f
        self._det_chunks.append((boxes, scores, keep_mask, ids))
        self._det_ready += boxes.shape[0]

    def add_pose(self, kpts, valid) -> None:
        self._pose_chunks.append((kpts, valid))
        self._pose_ready += kpts.shape[0]

    def add_ball(self, x: int, y: int, v: int) -> None:
        self.ball_x.append(x)
        self.ball_y.append(y)
        self.ball_v.append(v)

    def add_court(self, kpts, valid) -> None:
        """(F, 12, 2) source-pixel keypoints and (F,) validity of a model
        court."""
        self._court_chunks.append((kpts, valid))
        self._court_ready += kpts.shape[0]

    def _materialize(self) -> None:
        for boxes, scores, keep_mask, ids in self._det_chunks:
            for f in range(boxes.shape[0]):
                self.players_objs.append(Players([
                    Player(xyxy=boxes[f, i], id=int(ids[f, i]), class_id=0,
                           confidence=float(scores[f, i]))
                    for i in np.flatnonzero(keep_mask[f])
                ]))
        self._det_chunks.clear()
        for kpts, valid in self._pose_chunks:
            for f in range(kpts.shape[0]):
                self.pose_objs.append(PlayersKeypoints([
                    PlayerKeypoints([
                        PlayerKeypoint(id=i, name=PlayerKeypoints.KEYPOINTS_NAMES[i],
                                       xy=(float(kpts[f, d, i, 0]), float(kpts[f, d, i, 1])))
                        for i in range(kpts.shape[2])
                    ])
                    for d in range(kpts.shape[1]) if valid[f, d]
                ]))
        self._pose_chunks.clear()
        for kpts, valid in self._court_chunks:
            self.court_objs += self.pipeline.court.to_keypoints(kpts, valid)
        self._court_chunks.clear()

    def _ball_obj(self, i: int) -> Ball:
        # Int truncation at both scale steps, as the per-tracker path.
        x = int(int(self.ball_x[i]) * self.w_scaler)
        y = int(int(self.ball_y[i]) * self.h_scaler)
        return Ball(frame=i, xy=(float(x), float(y)), visibility=int(self.ball_v[i]))

    def _court(self, lo: int, hi: int):
        mode = self.pipeline.court_mode
        if mode is None:
            return None
        if mode == "fixed":
            return [self.pipeline.court.fixed_keypoints_detection] * (hi - lo)
        return self.court_objs[lo:hi]

    def maybe_emit(self) -> None:
        """Push newly finalized frames to the stream callback."""
        if self.stream is None:
            return
        n_ready = min(self._det_ready, self._pose_ready, len(self.ball_x))
        if self.pipeline.court_mode in ("yolo", "resnet"):
            n_ready = min(n_ready, self._court_ready)
        if n_ready <= self._emitted:
            return
        self._materialize()
        lo, hi = self._emitted, n_ready
        self.stream(self.players_objs[lo:hi], self.pose_objs[lo:hi],
                    [self._ball_obj(i) for i in range(lo, hi)], self._court(lo, hi))
        self._emitted = n_ready

    @traced("fused.finish")
    def finish(self) -> dict[str, list]:
        self._materialize()
        if len(self.ball_x) != self.n:
            raise RuntimeError(f"emitted {len(self.ball_x)} ball rows for {self.n} frames")
        balls = [self._ball_obj(i) for i in range(self.n)]
        ball = self.pipeline.ball
        if ball.inpaintnet is not None:  # the inpaint pass over the whole clip
            with tracer.span("ball.inpaint"):
                balls = ball.balls({"x": [int(b.xy[0]) for b in balls],
                                    "y": [int(b.xy[1]) for b in balls],
                                    "visibility": [b.visibility for b in balls]}, self.n)
        results = {"players": self.players_objs, "players_keypoints": self.pose_objs,
                   "ball": balls}
        court = self._court(0, self.n)
        if court is not None:
            if len(court) != self.n:
                raise RuntimeError(f"{len(court)} court results for {self.n} frames")
            results["keypoints"] = court
        return results


class _Download(NamedTuple):
    """A sub-step's packed result on its way to the host: the pinned host
    buffer (filled once `done` has completed), its layout, and the device
    buffer, held until the drain."""

    host: torch.Tensor
    layout: Layout
    done: Optional[torch.cuda.Event]
    device_buf: torch.Tensor

    def take(self, n: int) -> tuple[torch.Tensor, Layout]:
        """The first n rows of the host buffer, once the copy is done, and
        the layout."""
        if self.done is not None:
            with tracer.span("fused.drain_wait"):
                self.done.synchronize()
        return self.host[:n], self.layout


class _RoundDownload(_Download):
    """A staged round's rows: on a card the host buffer is the lane graph's
    pinned buffer, which the round after next overwrites, so `take` hands
    out a copy."""

    def take(self, n: int) -> tuple[torch.Tensor, Layout]:
        host, layout = _Download.take(self, n)
        return host.clone(), layout


class _Chunk(NamedTuple):
    lo: int  # first frame
    n_real: int  # frames of the clip in it
    det: Optional[_Download]
    pose: Optional[_Download]
    ball: _Download
    court: Optional[_Download]  # a model court's chunk


class _BallState(NamedTuple):
    """Device-resident ball-branch state of one run."""

    median: torch.Tensor  # (H, W, 3) model-resolution median, 'concat'
    median_src: Optional[torch.Tensor]  # (Hs, Ws, 3) fp32, subtract modes
    coef: torch.Tensor  # (n_ext_pad, L) ensemble coefficients
    swap: torch.Tensor  # (n_ext_pad,) channel-quirk flags
    frame_carry: torch.Tensor  # (L-1, H, W, C_f)
    heat_carry: torch.Tensor  # (L-1, L, H, W)


class _Staged:
    """A staged configuration's device buffers and lane graphs, kept across
    runs of `FusedPipeline.run_staged`.

    Round r's decoded frames go to `frames[r % 2]`: round r + 1 is uploaded
    and decoded into the other buffer while round r's lanes read this one,
    and the decode of round r + 2 waits on the events in `free[r % 2]`,
    recorded behind round r's lanes. The I420 wire buffer is one: the
    decode reads it on the copy lane right after its upload. The ball's
    state is one set of tensors that its graphs read: the median (refilled
    each run), the carries (zeroed each run, written back by each round)
    and the round's coefficient and flag rows (refilled on the ball lane
    before each replay). `graphs` holds a `LaneGraph` for each (lane,
    parity), captured with the weights that `weights` names."""

    def __init__(self, pipe: "FusedPipeline", src_hw: tuple[int, int], superchunk: int):
        ball, dev = pipe.ball, pipe.device
        self.rows = pipe.chunk * superchunk
        (wh, ww), _, _ = pipe._wire(src_hw)

        def empty(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.frames = [empty(self.rows, wh, ww, 3, dtype=torch.uint8) for _ in range(2)]
        self.wire = (None if pipe.ingest == "rgb" else
                     empty(self.rows, *pipe._wire_shape(src_hw)[1:], dtype=torch.uint8))
        seq_len = ball.tracknet_seq_len
        self.state = _BallState(
            median=empty(ball.HEIGHT, ball.WIDTH, 3, dtype=torch.uint8),
            median_src=(empty(wh, ww, 3) if ball.bg_mode in ("subtract", "subtract_concat")
                        else None),
            coef=empty(self.rows, seq_len),
            swap=empty(self.rows),
            frame_carry=empty(seq_len - 1, ball.HEIGHT, ball.WIDTH, frame_channels(ball.bg_mode)),
            heat_carry=empty(seq_len - 1, seq_len, ball.HEIGHT, ball.WIDTH),
        )
        self.core = pipe._ball_core(src_hw)
        # The plans whose device operands the graphs read, held for them.
        self.plans = pipe._plans(src_hw)
        self.free: list[list] = [[], []]
        self.graphs: dict[tuple[str, int], LaneGraph] = {}
        self.weights: dict[str, tuple] = {}
        self.models: dict = {}


class FusedPipeline:
    """Runs the players, pose and ball trackers (and a court, fixed or from
    a model) over one upload per chunk of frames (`run`), or per round of
    chunks (`run_staged`)."""

    def __init__(
        self,
        players: PlayerTracker,
        pose: PlayerKeypointsTracker,
        ball: BallTracker,
        court: Optional[KeypointsTracker] = None,
        chunk: int = 16,
        ingest: str = "rgb",
        association: str = "auto",
        wire_long_side: int = 960,
        ball_stride: int = 1,
    ):
        self.check_options(ingest, association, ball_stride, ball.tracknet_seq_len, chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        # 'fixed' costs nothing; 'yolo' and 'resnet' run as a fourth
        # sub-step over the shared upload (a moving camera's court).
        if court is None:
            self.court_mode = None
        elif court.fixed_keypoints_detection is not None:
            self.court_mode = "fixed"
        else:
            self.court_mode = court.model_type
        models = (players, pose, ball) + ((court,) if self.court_mode in ("yolo", "resnet")
                                          else ())
        devices = {torch.device(t.device) for t in models}
        if len(devices) != 1:
            raise ValueError(f"the trackers lie on different devices: {sorted(map(str, devices))}")
        self.players = players
        self.pose = pose
        self.ball = ball
        self.court = court
        self.chunk = chunk
        # 'i420': frames cross the host->device link as I420 planes (1.5
        # bytes a pixel against RGB's 3), rebuilt on the device bit-exactly
        # to cv2's I420->RGB; the only deviation from 'rgb' is the chroma
        # subsampling round trip. 'derived': the same at the wire
        # resolution (`_wire`); the outputs also move by the resample chain.
        self.ingest = ingest
        self._ingest_pref = ingest
        self.wire_long_side = int(wire_long_side)
        # 'host': ByteTrack at the drain (exact parity); 'device': the
        # association scan (greedy + constant velocity, ops/association_scan.py);
        # 'auto': host in `run`, the scan in `run_mesh`.
        self.association = association
        # 1: the reference's stride-1 rolling ensemble; seq_len: nonoverlap.
        self.ball_stride = ball_stride
        self.device = devices.pop()
        self.lanes = Lanes(self.device)
        self._step_cache: dict = {}
        self._rings: dict = {}
        self._staged: Optional[tuple[tuple, _Staged]] = None
        self.last_staged_split: Optional[dict] = None
        self.last_staged_graphs: Optional[dict] = None

    @staticmethod
    def check_options(ingest: str, association: str = "auto", ball_stride: int = 1,
                      seq_len: Optional[int] = None, chunk: Optional[int] = None) -> None:
        """Refuse unknown options (ValueError). ball_stride is 1 or, with
        `chunk` a multiple of it, the ball tracker's `seq_len` (checked where
        they are given)."""
        if ingest not in ("rgb", "i420", "derived"):
            raise ValueError(f"unknown ingest {ingest!r}")
        if association not in ("host", "device", "auto"):
            raise ValueError(f"unknown association {association!r}")
        if seq_len is not None and ball_stride not in (1, seq_len):
            raise ValueError(f"ball_stride must be 1 (the reference's stride-1 ensemble) or "
                             f"seq_len={seq_len} (nonoverlap), got {ball_stride}")
        if ball_stride < 1:
            raise ValueError(f"ball_stride must be >= 1, got {ball_stride}")
        if ball_stride != 1 and chunk is not None and chunk % ball_stride:
            raise ValueError(f"nonoverlap ball_stride needs chunk % seq_len == 0 "
                             f"(chunk={chunk}, seq_len={ball_stride})")

    def _scan(self, mesh: bool) -> Optional[_Scan]:
        """The association scan of a run (None: host ByteTrack): 'device',
        or 'auto' on the mesh path, whose ByteTrack loop every rank would
        repeat on the host."""
        if self.association == "device" or (self.association == "auto" and mesh):
            return _Scan()
        return None

    @property
    def _ball_off(self) -> int:
        """Frames of clip zero-extension and of ball-emit lag: seq_len - 1
        under the stride-1 rolling ensemble, 0 in the nonoverlap mode (chunk
        k's ball rows are its own frames)."""
        return 0 if self.ball_stride != 1 else self.ball.tracknet_seq_len - 1

    def _wire(self, src_hw: tuple[int, int]):
        """((wire_h, wire_w), sx, sy): the on-the-wire frame resolution and
        the wire->source coordinate scale. The identity but in the 'derived'
        ingest, whose wire frame is the aspect-preserving downscale to a
        long side of at most `wire_long_side`, rounded to even dimensions
        (I420's chroma is 2x2-subsampled)."""
        if self.ingest != "derived":
            return tuple(src_hw), 1.0, 1.0
        h, w = src_hw
        scale = min(1.0, self.wire_long_side / max(h, w))
        wh = max(2, int(round(h * scale / 2)) * 2)
        ww = max(2, int(round(w * scale / 2)) * 2)
        return (wh, ww), w / ww, h / wh

    def _ingest_decode(self, src_hw: tuple[int, int]):
        """Raw uploaded chunk -> (B, H', W', 3) uint8 RGB frames on the
        device, at the wire resolution (H', W')."""
        if self.ingest in ("i420", "derived"):
            h = self._wire(src_hw)[0][0]
            return lambda buf: i420_to_rgb(buf, h, dtype=torch.uint8)
        return lambda frames: frames

    def _check_ingest(self, src_hw: tuple[int, int]) -> None:
        """Pick the run's wire format from the configured preference: I420
        needs even dimensions. Recomputed per run (not a one-way latch), so
        one odd-dimension clip does not downgrade every later run of a
        cached pipeline to twice the ingest bytes. 'derived' rounds its
        wire dimensions to even, so it needs no fallback."""
        self.ingest = self._ingest_pref
        if self.ingest == "i420" and (src_hw[0] % 2 or src_hw[1] % 2):
            print(f"fused: {tuple(src_hw)} has odd dimensions; falling back to rgb ingest")
            self.ingest = "rgb"

    def wire_bytes_per_frame(self, src_hw: tuple[int, int]) -> int:
        """Bytes one frame costs on the host->device link in the current
        wire format."""
        (wh, ww), _, _ = self._wire(src_hw)
        return wh * ww * 3 // 2 if self.ingest in ("i420", "derived") else wh * ww * 3

    def _wire_shape(self, src_hw: tuple[int, int]) -> tuple[int, ...]:
        """Shape of one chunk on the wire."""
        (wh, ww), _, _ = self._wire(src_hw)
        if self.ingest in ("i420", "derived"):
            return (self.chunk, wh * 3 // 2, ww)
        return (self.chunk, wh, ww, 3)

    def _ring(self, src_hw: tuple[int, int], frames: Optional[int] = None,
              slots: int = STAGING_SLOTS) -> StagingRing:
        """The staging ring for this wire shape (a chunk, or `frames`
        frames), kept across runs (pinning ~100 MB a slot at 1080p is
        slow)."""
        shape = self._wire_shape(src_hw)
        if frames is not None:
            shape = (frames,) + shape[1:]
        if shape not in self._rings:
            self._rings[shape] = StagingRing(shape, slots, self.device)
        return self._rings[shape]

    def _pack_chunk(self, chunk_frames: list[np.ndarray], out: np.ndarray,
                    pool: ThreadPoolExecutor) -> np.ndarray:
        """Host-side chunk packing in the ingest's wire format, frame by
        frame into `out` (a staging slot), on `pool`'s threads. 'derived':
        INTER_AREA to the wire resolution, then I420 from its planes."""
        if self.ingest == "derived":
            wire_hw = self._wire(chunk_frames[0].shape[:2])[0]

            def pack(i):
                planes_to_i420(resize_area_planes(chunk_frames[i], wire_hw), out=out[i])
        elif self.ingest == "i420":
            def pack(i):
                rgb_to_i420(chunk_frames[i], out=out[i])
        else:
            def pack(i):
                np.copyto(out[i], chunk_frames[i])
        list(pool.map(pack, range(len(chunk_frames))))
        return out

    # ------------------------------------------------------------------
    # The three sub-steps. Each takes the chunk's (B, H, W, 3) uint8 RGB
    # frames on the device and returns (packed buffer, layout) with no host
    # sync; the ball step also takes and returns its carries.

    def _build_det_step(self, src_hw: tuple[int, int]):
        return self.players.device_step

    def _build_pose_step(self, src_hw: tuple[int, int]):
        return self.pose.device_step

    def _build_ball_step(self, src_hw: tuple[int, int]):
        """`run`'s ball step over chunk k (its first frame `lo`): the
        chunk's rows of the run's coefficient table (row lo + j holds the
        coefficients of frame lo + j - (L-1)) and, where any frame of the
        chunk is flagged (`swap`), of the channel-quirk flags."""
        b = self.chunk
        core = self._ball_core(src_hw)

        def ball_step(frames, state: _BallState, lo: int, swap: bool):
            flags = state.swap[lo: lo + b] if swap else None
            return core(frames, state, state.coef[lo: lo + b], flags)

        return ball_step

    def _ball_core(self, src_hw: tuple[int, int]):
        """The ball sub-step over one chunk of wire frames, given its (B, L)
        coefficient rows and its (B,) channel-quirk flags (or None): (the
        packed rows and layout, the state with the new carries). The swap
        applies to the ball branch only, before the difference / resize;
        det and pose keep RGB. All-zero flags give the bits of None."""
        ball = self.ball
        # 'derived': the resize to model resolution starts from the wire
        # frames; the subtract modes' median is downscaled to the wire
        # resolution on the host (_gather_setup) to match.
        pre = make_frame_preprocess(self._wire(src_hw)[0], (ball.HEIGHT, ball.WIDTH),
                                    ball.bg_mode)

        if self.ball_stride != 1:
            def core_nonoverlap(frames, state: _BallState, coef, flags):
                # The chunk's own frames in windows of seq_len, each run
                # once; the carries pass through, the coefficients unread.
                resized = pre(frames, median_src=state.median_src, swap=flags)
                cx, cy, vis = ball._nonoverlap_step(resized, state.median)
                return pack_rows([torch.stack([cx, cy, vis], dim=-1)]), state

            return core_nonoverlap

        def core(frames, state: _BallState, coef, flags):
            resized = pre(frames, median_src=state.median_src, swap=flags)
            cx, cy, vis, frame_carry, heat_carry = ball._window_step(
                resized, state.median, state.frame_carry, state.heat_carry, coef)
            packed = pack_rows([torch.stack([cx, cy, vis], dim=-1)])
            return packed, state._replace(frame_carry=frame_carry, heat_carry=heat_carry)

        return core

    def _build_court_step(self, src_hw: tuple[int, int]):
        """The fourth sub-step, a model court's device half over the wire
        frames. 'resnet' scales its keypoints from wire to source pixels on
        the device; 'yolo' at the drain (`_unpack_frames`), after the host's
        NMS pass. None for no court or a fixed one."""
        if self.court_mode not in ("yolo", "resnet"):
            return None
        court = self.court
        if self.court_mode == "yolo":
            return court.device_step
        _, sx, sy = self._wire(src_hw)
        to_source = torch.tensor([sx, sy], dtype=torch.float32, device=self.device)
        return lambda frames: court.device_step(frames, to_source)

    def _get_steps(self, src_hw: tuple[int, int]):
        """(decode, det, pose, ball, court or None) steps, cached per
        (resolution, chunk, bg_mode, ingest, wire, court, ball stride).
        Uploads every resize plan's operands (dense matrices or bands, as
        each pass takes them) and the court's constants to the device here,
        on the current stream, so no step uploads any."""
        key = self._steps_key(src_hw)
        if key not in self._step_cache:
            self._step_cache[key] = (
                self._ingest_decode(src_hw),
                self._build_det_step(src_hw),
                self._build_pose_step(src_hw),
                self._build_ball_step(src_hw),
                self._build_court_step(src_hw),
            )
        self._plans(src_hw)
        return self._step_cache[key]

    def _steps_key(self, src_hw: tuple[int, int]) -> tuple:
        return (tuple(src_hw), self.chunk, self.ball.bg_mode, self.ingest,
                self._wire(src_hw)[0], self.court_mode, self.ball_stride)

    def _plans(self, src_hw: tuple[int, int]) -> list:
        """The resize plans the sub-steps run from the wire frames, their
        operands uploaded to the device (and the court's constants)."""
        wire = self._wire(src_hw)[0]
        size = self.pose.train_image_size
        plans = [letterbox_plan(wire, self.players.IMGSZ).plan,
                 resize_plan(wire, (size, size), "pil_bicubic"),
                 resize_plan(wire, (self.ball.HEIGHT, self.ball.WIDTH), "pil_bicubic")]
        if self.court_mode == "yolo":
            size = self.court.TRAIN_IMAGE_SIZE
            plans.append(resize_plan(wire, (size, size), "pil_bicubic"))
        elif self.court_mode == "resnet":
            size = self.court.RESNET_SIZE
            plans.append(resize_plan(wire, (size, size), "pil_bilinear"))
            imagenet_stats(self.device)
        for plan in plans:
            plan.upload(self.device)
        return plans

    def _ball_device_setup(self, n: int, median_resized, median_src, quirk_flags) -> _BallState:
        """Device-resident ball-branch state for an n-frame clip, around the
        median tensors `_gather_setup` left on the device. The tables are
        padded so chunk k's rows are table[lo : lo + b] (out-of-range frames
        are zero rows)."""
        b = self.chunk
        ball = self.ball
        seq_len = ball.tracknet_seq_len
        coef, swap = self._ball_tables(n, quirk_flags, (-(-(n + seq_len - 1) // b)) * b + b)
        dev = self.device
        return _BallState(
            median=median_resized,
            median_src=median_src,
            coef=torch.from_numpy(coef).to(dev),
            swap=torch.from_numpy(swap).to(dev),
            frame_carry=torch.zeros((seq_len - 1, ball.HEIGHT, ball.WIDTH,
                                     frame_channels(ball.bg_mode)), dtype=torch.float32,
                                    device=dev),
            heat_carry=torch.zeros((seq_len - 1, seq_len, ball.HEIGHT, ball.WIDTH),
                                   dtype=torch.float32, device=dev),
        )

    def _ball_tables(self, n: int, quirk_flags, rows: int) -> tuple[np.ndarray, np.ndarray]:
        """An n-frame clip's (rows, L) ensemble coefficients (row f + L-1:
        frame f's) and (rows,) channel-quirk flags (row f: frame f's), fp32,
        zero past the clip."""
        seq_len = self.ball.tracknet_seq_len
        coef = np.zeros((rows, seq_len), np.float32)
        coef[seq_len - 1: seq_len - 1 + n] = overlap_ensemble_coefficients(n, seq_len,
                                                                            self.ball.EVAL_MODE)
        swap = np.zeros(rows, np.float32)
        swap[:n] = quirk_flags
        return coef, swap

    def _setup(self, frame_iter, total_frames):
        """The run's set-up, before any chunk: the median, the steps (and
        their plans' matrices), the ball state on the ball lane, and every
        lane ordered after it."""
        median_resized, median_src, fw, quirk_flags, n, src_hw = self._gather_setup(
            frame_iter, total_frames)
        steps = self._get_steps(src_hw)
        lanes = self.lanes
        lanes.after_current()
        with lanes.on(lanes.ball):  # the state is allocated and used on the ball lane
            state = self._ball_device_setup(n, median_resized, median_src, quirk_flags)
        return fw, quirk_flags, n, src_hw, steps, state

    # ------------------------------------------------------------------

    def run(self, frame_iter: Iterable[np.ndarray], total_frames: int,
            stream=None) -> dict[str, list]:
        """Consume RGB uint8 frames; returns per-tracker prediction lists
        keyed 'players', 'players_keypoints', 'ball' and, with a court,
        'keypoints'.

        stream: optional callback(players_new, pose_new, ball_new,
        court_new) called in frame order as results finalize, so the caller
        can consume them while inference runs."""
        with torch.inference_mode(), tracer.run(total_frames):
            with tracer.span("fused.setup"):
                fw, quirk_flags, n, src_hw, steps, state = self._setup(frame_iter, total_frames)
                ring = self._ring(src_hw)
                zero_frame = np.zeros_like(fw.first())
                builder = _ResultBuilder(self, n, src_hw, stream, self._scan(mesh=False))
            b = self.chunk
            # Zero-extend the clip by seq_len-1 frames: every output frame,
            # the tail included, is emitted by the uniform chunk loop.
            n_ext = n + self._ball_off
            num_chunks = -(-n_ext // b)

            @tracer.bind
            def prepare(k: int) -> int:
                return self._prepare(fw, ring, k, k * b, b, n, zero_frame, pack_pool)

            # The next chunk's decode and pack (numpy, which releases the
            # interpreter lock) run in a worker while this thread queues the
            # current chunk's device work and drains the oldest chunk.
            with ThreadPoolExecutor(PACK_THREADS) as pack_pool, \
                    ThreadPoolExecutor(1) as prefetch:
                self._run_chunk_loop(num_chunks, prefetch, prepare, steps, ring, n,
                                     quirk_flags, state, builder, src_hw)
            return builder.finish()

    @traced("fused.pack")
    def _prepare(self, fw: _FrameWindow, ring: StagingRing, k: int, lo: int, count: int, n: int,
                 zero_frame: np.ndarray, pool: ThreadPoolExecutor) -> int:
        """Host side of chunk (or round) k, frames [lo, lo + count): decode
        fill, then pack into its staging slot once the slot's last upload is
        done. Only the ball's tail, past the clip's n frames, is zero
        frames; a frame iterator that runs dry before n raises ValueError.
        Returns lo."""
        hi = min(lo + count, n)
        avail = fw.fill_to(hi)
        if avail < hi:
            raise ValueError(f"the frame iterator ran dry after {avail} frames of "
                             f"total_frames={n}")
        frames = [fw.get(i) if i < n else zero_frame for i in range(lo, lo + count)]
        self._pack_chunk(frames, ring.acquire(k), pool)
        fw.drop_below(hi)  # frames are kept until packed
        return lo

    def _run_chunk_loop(self, num_chunks, prefetch, prepare, steps, ring, n, quirk_flags,
                        state, builder, src_hw) -> None:
        """Dispatch chunk after chunk, keeping up to IN_FLIGHT of them on the
        device; each chunk's host side is prepared one ahead in `prefetch`."""
        next_prep = prefetch.submit(prepare, 0)
        pending: collections.deque[_Chunk] = collections.deque()
        for k in range(num_chunks):
            with tracer.span("fused.prep_wait"):
                lo = next_prep.result()
            if k + 1 < num_chunks:
                next_prep = prefetch.submit(prepare, k + 1)
            chunk, state = self._dispatch(steps, ring, k, lo, n, quirk_flags, state)
            pending.append(chunk)
            if len(pending) > IN_FLIGHT:
                self._drain(pending.popleft(), builder, n, src_hw)
        while pending:
            self._drain(pending.popleft(), builder, n, src_hw)

    @traced("fused.dispatch")
    def _dispatch(self, steps, ring: StagingRing, k: int, lo: int, n: int, quirk_flags,
                  state: _BallState):
        """Queue chunk k's device work: the upload and decode on the copy
        lane, each sub-step on its own lane after them, each ending in one
        D2H copy of its packed buffer. Returns (the chunk's record, the new
        ball state)."""
        decode, det_step, pose_step, ball_step, court_step = steps
        lanes = self.lanes
        frames, ready = self._upload(ring, k, decode)
        n_real = max(0, min(lo + self.chunk, n) - lo)

        def ball(f):
            nonlocal state
            packed, state = ball_step(f, state, lo, swap)
            return packed

        def launch(lane, step) -> _Download:
            return self._launch(lane, step, frames, ready)

        swap = bool(np.any(quirk_flags[lo: lo + self.chunk]))
        # A chunk of padding only (the ball's tail) runs the ball step alone.
        det = launch(lanes.det, det_step) if n_real else None
        pose = launch(lanes.pose, pose_step) if n_real else None
        ball_download = launch(lanes.ball, ball)  # sets the new state
        court = launch(lanes.court, court_step) if n_real and court_step else None
        return _Chunk(lo, n_real, det, pose, ball_download, court), state

    def _upload(self, ring: StagingRing, k: int, decode):
        """Chunk k's upload and ingest decode on the copy lane: (frames, an
        event behind them)."""
        lanes = self.lanes
        with tracer.span("fused.upload"), lanes.on(lanes.copy):
            frames = decode(ring.upload(k))
            return frames, lanes.record(lanes.copy)

    def _launch(self, lane, step, frames, ready, gather=None) -> _Download:
        """`step` over the uploaded frames on `lane` after `ready`, its packed
        buffer (all-gathered over a mesh by `gather`) copied to the host."""
        lanes = self.lanes
        with lanes.on(lane):
            lanes.wait(lane, ready)
            if lane is not None:
                # frames was allocated on the copy lane: keep the allocator
                # from reusing it while this lane reads it.
                frames.record_stream(lane)
            buf, layout = step(frames)
            if gather is not None:
                buf = gather(buf)
            return _Download(to_host(buf), layout, lanes.record(lane), buf)

    def _unpack_frames(self, results, chunk: _Chunk, src_hw) -> None:
        """The det, pose and court downloads of a chunk's clip frames, once
        done, through the trackers' host halves into the run's `results`;
        the det boxes and the yolo court's keypoints from wire to source
        pixels where the wire is smaller."""
        n_real = chunk.n_real
        wire = self._wire(src_hw)
        results.add_det(*self.players.host_step(*chunk.det.take(n_real), src_hw,
                                                wire=wire if wire[0] != tuple(src_hw) else None))
        kpts, _, valid = self.pose.host_step(*chunk.pose.take(n_real), src_hw)
        results.add_pose(kpts, valid)
        if chunk.court is not None:
            kpts, valid = self.court.host_step(*chunk.court.take(n_real), wire[0])
            if self.court_mode == "yolo":
                kpts = kpts * np.asarray(wire[1:], np.float32)  # fp32, as on the device
            results.add_court(kpts, valid)

    @traced("fused.drain")
    def _drain(self, chunk: _Chunk, builder: _ResultBuilder, n: int, src_hw) -> None:
        """Wait for a chunk's (or a staged round's) downloads, then its host
        work: the trackers' host halves, ByteTrack and the ball rows."""
        if chunk.n_real:
            self._unpack_frames(builder, chunk, src_hw)
        (packed,) = unpack_rows(*chunk.ball.take(chunk.ball.host.shape[0]))
        emit_lo = chunk.lo - self._ball_off
        for j, (x, y, v) in enumerate(packed.tolist()):
            if 0 <= emit_lo + j < n:
                builder.add_ball(x, y, v)
        builder.maybe_emit()

    # ------------------------------------------------------------------

    def measure_device_split(self, frame_iter: Iterable[np.ndarray], total_frames: int,
                             n_chunks: int = 4) -> Optional[dict]:
        """Device time of each fused sub-step over chunks already resident
        on the device.

        Packs `n_chunks` chunks on the host (timed on the host clock), uploads
        and decodes each (device time: CUDA events around the copy and the
        decode), then runs each sub-step alone over the resident chunks, one
        phase after another on the current stream, each timed with CUDA
        events after an untimed warm-up. Meant for a warm pipeline.

        Returns {"pack_s", "upload_s", "det_s", "pose_s", "ball_s",
        ["court_s",] "frames", "device_ms_per_frame", "device_fps"} in
        seconds (the last two over the sub-steps; court_s with a model
        court), or None when the clip is shorter than one chunk. On the CPU
        the times are host wall times."""
        b = self.chunk
        with torch.inference_mode(), tracer.run(total_frames):
            fw, _, n, src_hw, steps, state = self._setup(frame_iter, total_frames)
            if n < b:
                return None
            self.lanes.current_after_all()  # the phases run on the current stream
            decode, det_step, pose_step, ball_step, court_step = steps
            n_chunks = min(n_chunks, n // b)
            ring = self._ring(src_hw)
            timer = DeviceTimer(self.device)
            raw = {"pack_s": 0.0, "upload_s": 0.0}
            resident = []
            fw.fill_to(n_chunks * b)
            with ThreadPoolExecutor(PACK_THREADS) as pool:
                for k in range(n_chunks):
                    slot = ring.acquire(k)
                    t0 = time.perf_counter()
                    self._pack_chunk([fw.get(i) for i in range(k * b, (k + 1) * b)], slot, pool)
                    raw["pack_s"] += time.perf_counter() - t0
                    fw.drop_below((k + 1) * b)
                    timer.start()
                    resident.append(decode(ring.upload(k)))
                    raw["upload_s"] += timer.stop()

            def ball_phase():
                s = state
                for k, frames in enumerate(resident):
                    _, s = ball_step(frames, s, k * b, False)

            phases = {
                "det_s": lambda: [det_step(f) for f in resident],
                "pose_s": lambda: [pose_step(f) for f in resident],
                "ball_s": ball_phase,
            }
            if court_step is not None:
                phases["court_s"] = lambda: [court_step(f) for f in resident]
            for name, phase in phases.items():
                phase()  # warm-up
                timer.start()
                phase()
                raw[name] = timer.stop()
        compute_s = sum(raw[name] for name in phases)
        frames = n_chunks * b
        return {**raw, "frames": frames, "device_ms_per_frame": compute_s / frames * 1e3,
                "device_fps": frames / max(compute_s, 1e-9)}

    # ------------------------------------------------------------------

    def run_staged(self, frame_iter: Iterable[np.ndarray], total_frames: int,
                   superchunk: int = 16, stream=None) -> dict[str, list]:
        """Like `run`, a round of `superchunk` x chunk frames at a time: per
        round one pinned upload and the ingest decode on the copy lane, then
        on each sub-step's lane one replay of the CUDA graph of its
        `superchunk` chunk steps (on the CPU the same steps, eagerly) and
        one copy of the round's packed rows to the host; the previous round
        is drained on the host meanwhile, and `stream` is fed once a round.
        The results equal `run`'s byte for byte. Det, pose and a model court
        also run over the last round's padding chunks; the drain cuts them.

        `last_staged_split`: host seconds of the loop's terms (setup_s,
        prep_wait_s, upload_s, dispatch_s (captures included), assoc_s,
        drain_s), from the run's spans. `last_staged_graphs`: each lane's
        graph replays in the run, the lane graphs built and captured (and the
        capture seconds), the pinned host bytes of the round buffers."""
        if superchunk < 1:
            raise ValueError(f"superchunk must be >= 1, got {superchunk}")
        with torch.inference_mode(), tracer.run(total_frames) as record:
            with tracer.span("fused.setup"):
                median_resized, median_src, fw, quirk_flags, n, src_hw = self._gather_setup(
                    frame_iter, total_frames)
                steps = self._get_steps(src_hw)
                entry = self._staged_entry(src_hw, superchunk)
                rows = entry.rows
                num_rounds = -(-(n + self._ball_off) // rows)
                coef, swap = self._ball_tables(n, quirk_flags, num_rounds * rows + self.chunk)
                st = entry.state
                st.median.copy_(median_resized)
                if st.median_src is not None:
                    st.median_src.copy_(median_src)
                st.frame_carry.zero_()
                st.heat_carry.zero_()
                tables = (torch.from_numpy(coef).to(self.device),
                          torch.from_numpy(swap).to(self.device))
                self.lanes.after_current()
                ring = self._ring(src_hw, rows, slots=2)
                zero_frame = np.zeros_like(fw.first())
                builder = _ResultBuilder(self, n, src_hw, stream, self._scan(mesh=False))
                before = {id(g): (g.replays, g.graph is not None) for g in entry.graphs.values()}

            @tracer.bind
            def prepare(r: int) -> int:
                return self._prepare(fw, ring, r, r * rows, rows, n, zero_frame, pack_pool)

            # Round r + 1 is packed in `prefetch` while round r is queued and
            # round r - 1 drained.
            with ThreadPoolExecutor(PACK_THREADS) as pack_pool, \
                    ThreadPoolExecutor(1) as prefetch:
                next_prep = prefetch.submit(prepare, 0)
                pending: Optional[_Chunk] = None
                for r in range(num_rounds):
                    with tracer.span("fused.prep_wait"):
                        lo = next_prep.result()
                    if r + 1 < num_rounds:
                        next_prep = prefetch.submit(prepare, r + 1)
                    current = self._dispatch_round(entry, steps, ring, r, lo, n, tables)
                    if pending is not None:
                        self._drain(pending, builder, n, src_hw)
                    pending = current
                self._drain(pending, builder, n, src_hw)
            self.lanes.current_after_all()
            results = builder.finish()
        self.last_staged_split = self._staged_split(record)
        self.last_staged_graphs = self._graph_stats(entry, ring, before, record)
        return results

    @staticmethod
    def _staged_split(record: RunRecord) -> dict[str, float]:
        """`last_staged_split` from a staged run's record: the upload is
        part of each round's dispatch span, the association of each drain's."""
        upload, assoc = record.seconds("fused.upload"), record.seconds("fused.assoc")
        return {"setup_s": record.seconds("fused.setup"),
                "prep_wait_s": record.seconds("fused.prep_wait"), "upload_s": upload,
                "dispatch_s": record.seconds("fused.dispatch") - upload, "assoc_s": assoc,
                "drain_s": record.seconds("fused.drain") - assoc}

    def _staged_entry(self, src_hw: tuple[int, int], superchunk: int) -> _Staged:
        """The staged buffers and graphs of this configuration (the key of
        `_get_steps` and the superchunk; one configuration kept), with the
        graphs of every model whose weights changed since their capture
        dropped (`weights_key`)."""
        key = self._steps_key(src_hw) + (superchunk,)
        if self._staged is None or self._staged[0] != key:
            self._staged = None  # the old buffers go before the new ones come
            self._staged = (key, _Staged(self, src_hw, superchunk))
        entry = self._staged[1]
        models = {"det": self.players.engine.model, "pose": self.pose.engine.model,
                  "ball": self.ball.tracknet.model}
        if self.court_mode in ("yolo", "resnet"):
            models["court"] = self.court.engine.model
        for name, model in models.items():
            weights = weights_key(model)
            if entry.weights.get(name) != weights:
                entry.weights[name] = weights
                entry.models[name] = model  # held: its id stays its own
                for p in (0, 1):
                    entry.graphs.pop((name, p), None)
        return entry

    @traced("fused.dispatch")
    def _dispatch_round(self, entry: _Staged, steps, ring: StagingRing, r: int, lo: int, n: int,
                        tables) -> _Chunk:
        """Queue round r's device work (its first frame `lo`): on the copy
        lane, once round r - 2's lanes let go of the round's frames buffer,
        the upload and the decode into it; on the ball lane the round's rows
        of the run's coefficient and flag tables; then on each lane its
        graph's replay after the decode and the copy of its rows to the
        host. Returns the round's record."""
        lanes, p, rows, b = self.lanes, r % 2, entry.rows, self.chunk
        decode = steps[0]
        frames = entry.frames[p]
        with tracer.span("fused.upload"):
            with lanes.on(lanes.copy):
                for event in entry.free[p]:
                    lanes.wait(lanes.copy, event)
                if entry.wire is None:
                    ring.upload(r, out=frames)
                else:
                    wire = ring.upload(r, out=entry.wire)
                    for c in range(0, rows, b):  # a chunk at a time: the decode's temporaries
                        frames[c: c + b].copy_(decode(wire[c: c + b]))
                ready = lanes.record(lanes.copy)
            coef, swap = tables
            with lanes.on(lanes.ball):
                entry.state.coef.copy_(coef[lo: lo + rows])
                entry.state.swap.copy_(swap[lo: lo + rows])
        named = [("det", lanes.det), ("pose", lanes.pose), ("ball", lanes.ball)]
        if self.court_mode in ("yolo", "resnet"):
            named.append(("court", lanes.court))
        downloads = {}
        for name, lane in named:
            graph = self._lane_graph(entry, steps, name, p, lane)
            with lanes.on(lane):
                lanes.wait(lane, ready)
                host, layout = graph.run()
                downloads[name] = _RoundDownload(host, layout, lanes.record(lane), graph.out)
        entry.free[p] = [d.done for d in downloads.values() if d.done is not None]
        return _Chunk(lo, max(0, min(lo + rows, n) - lo), downloads["det"], downloads["pose"],
                      downloads["ball"], downloads.get("court"))

    def _lane_graph(self, entry: _Staged, steps, name: str, p: int, lane) -> LaneGraph:
        """Lane `name`'s graph over `entry.frames[p]`, built on first use:
        the lane's sub-step over each chunk of the round, the packed rows
        concatenated; the ball's chunks carry their state from one to the
        next and write the last carries back. Its warm-up runs one chunk
        (the ball's on copies of the carries). The two parities of a lane
        share one memory pool: they replay in turn on the one lane."""
        graph = entry.graphs.get((name, p))
        if graph is not None:
            return graph
        b, frames, st, core = self.chunk, entry.frames[p], entry.state, entry.core
        chunks = [slice(c, c + b) for c in range(0, entry.rows, b)]

        def rows_of(packed: list) -> tuple[torch.Tensor, Layout]:
            return torch.cat([buf for buf, _ in packed]), packed[0][1]

        if name == "ball":
            def fn():
                state, packed = st, []
                for sl in chunks:
                    out, state = core(frames[sl], state, st.coef[sl], st.swap[sl])
                    packed.append(out)
                if self.ball_stride == 1:  # the next round's carries
                    st.frame_carry.copy_(state.frame_carry)
                    st.heat_carry.copy_(state.heat_carry)
                return rows_of(packed)

            def warm():
                core(frames[:b], st._replace(frame_carry=st.frame_carry.clone(),
                                             heat_carry=st.heat_carry.clone()),
                     st.coef[:b], st.swap[:b])
        else:
            step = {"det": steps[1], "pose": steps[2], "court": steps[4]}[name]

            def fn():
                return rows_of([step(frames[sl]) for sl in chunks])

            def warm():
                step(frames[:b])

        other = entry.graphs.get((name, 1 - p))
        pool = other.graph.pool() if other is not None and other.graph is not None else None
        graph = entry.graphs[(name, p)] = LaneGraph(fn, warm, lane, entry.weights[name], pool)
        return graph

    @staticmethod
    def _graph_stats(entry: _Staged, ring: StagingRing, before: dict, record: RunRecord) -> dict:
        """A run's graph record: replays by lane, graphs built, captured and
        their capture seconds (the run's `fused.capture` spans), the pinned
        host bytes of the round buffers."""
        replays: dict[str, int] = {}
        built = captured = 0
        for (name, _), g in entry.graphs.items():
            was_replays, was_captured = before.get(id(g), (0, False))
            built += id(g) not in before
            replays[name] = replays.get(name, 0) + g.replays - was_replays
            captured += g.graph is not None and not was_captured
        capture_s = record.seconds("fused.capture")
        pinned = ring.nbytes if ring.device.type == "cuda" else 0
        pinned += sum(g.host.numel() * g.host.element_size() for g in entry.graphs.values()
                      if g.host is not None)
        return {"replays": replays, "built": built, "captured": captured,
                "capture_s": capture_s, "pinned_bytes": pinned}

    def run_mesh(self, frame_iter: Iterable[np.ndarray], total_frames: int,
                 mesh: Mesh) -> dict[str, list]:
        """The fused run with the clip's frame axis split over `mesh`, one
        process a device; every rank passes the whole clip and gets the
        whole clip's results.

        Per block of chunk x ranks frames, each rank packs and uploads only
        its own chunk and runs det, pose, the ball's preprocess and a model
        court on it (through kernel K1 on a card); the packed rows and the
        uint8 preprocessed ball frames are all-gathered over the mesh's
        group, and every rank drains the block alike: the host halves, then
        the association scan (association 'auto' or 'device') or ByteTrack
        ('host'). The ball finishes with one `sharded_window_inference`
        over the gathered clip, the rank's windows in batches of the chunk.
        The trackers must lie on the mesh's device. Equal to `run` on the
        same clip where the models are (tests/test_torch_fused_mesh.py)."""
        if _resolved(mesh.device) != _resolved(self.device):
            raise ValueError(f"the trackers lie on {self.device}, the mesh's rank on {mesh.device}")
        ball, b = self.ball, self.chunk
        seq_len = ball.tracknet_seq_len
        block = b * mesh.size
        with torch.inference_mode(), tracer.run(total_frames):
            with tracer.span("fused.setup"):
                median_resized, median_src, fw, quirk_flags, n, src_hw = self._gather_setup(
                    frame_iter, total_frames)
                if n < seq_len or -(-n // mesh.size) < seq_len - 1:
                    raise ValueError(f"clip ({n} frames) too short for {mesh.size}-way frame "
                                     "sharding")
                steps = self._get_steps(src_hw)
                ball_pre = self._ball_pre_step(src_hw, n, median_src, quirk_flags, block)
                ring = self._ring(src_hw)
                zero_frame = np.zeros_like(fw.first())
                builder = _ResultBuilder(self, n, src_hw, None, self._scan(mesh=True))
            num_blocks = -(-n // block)
            pre_frames: list[torch.Tensor] = []

            @tracer.bind
            @traced("fused.pack")
            def prepare(k: int) -> int:
                """Host side of block k: read the block's frames, pack this
                rank's chunk of them."""
                lo = k * block + mesh.rank * b
                hi = min((k + 1) * block, n)
                avail = fw.fill_to(hi)
                if avail < hi:
                    raise ValueError(f"the frame iterator ran dry after {avail} frames of "
                                     f"total_frames={n}")
                frames = [fw.get(i) if i < n else zero_frame for i in range(lo, lo + b)]
                self._pack_chunk(frames, ring.acquire(k), pack_pool)
                fw.drop_below(hi)
                return lo

            with ThreadPoolExecutor(PACK_THREADS) as pack_pool, \
                    ThreadPoolExecutor(1) as prefetch:
                next_prep = prefetch.submit(prepare, 0)
                pending: collections.deque[_Chunk] = collections.deque()
                for k in range(num_blocks):
                    with tracer.span("fused.prep_wait"):
                        lo = next_prep.result()
                    if k + 1 < num_blocks:
                        next_prep = prefetch.submit(prepare, k + 1)
                    pending.append(self._dispatch_block(steps, ball_pre, ring, k, lo, n, mesh))
                    if len(pending) > IN_FLIGHT:
                        self._drain_block(pending.popleft(), builder, src_hw, pre_frames)
                while pending:
                    self._drain_block(pending.popleft(), builder, src_hw, pre_frames)
            self.lanes.current_after_all()

            # The ball: one halo-exchange window pass over the gathered clip.
            def apply(x):
                return ball.tracknet.model(x.to(ball.compute_dtype))

            cx, cy, vis = sharded_window_inference(
                apply, torch.cat(pre_frames), median_resized, mesh, seq_len=seq_len,
                eval_mode=ball.EVAL_MODE, bg_mode=ball.bg_mode, stride=self.ball_stride,
                batch=b)
            for x, y, v in zip(cx.tolist(), cy.tolist(), vis.tolist()):
                builder.add_ball(x, y, v)
            return builder.finish()

    def _ball_pre_step(self, src_hw, n: int, median_src, quirk_flags, block: int):
        """The mesh path's ball sub-step: a rank's chunk of wire frames ->
        (B, H, W, C_f) uint8 preprocessed frame channels (the channel quirk
        applied by frame), for the gathered clip's window pass."""
        ball, b = self.ball, self.chunk
        pre = make_frame_preprocess(self._wire(src_hw)[0], (ball.HEIGHT, ball.WIDTH),
                                    ball.bg_mode)
        flags = np.zeros(-(-n // block) * block, np.float32)
        flags[:n] = quirk_flags
        lanes = self.lanes
        lanes.after_current()
        with lanes.on(lanes.ball):  # allocated and read on the ball lane
            swap = torch.from_numpy(flags).to(self.device)

        def step(frames, lo: int):
            chunk_flags = swap[lo: lo + b] if np.any(flags[lo: lo + b]) else None
            out = pre(frames, median_src=median_src, swap=chunk_flags)
            return out.to(torch.uint8), None  # exact integers in [0, 255]

        return step

    @traced("fused.dispatch")
    def _dispatch_block(self, steps, ball_pre, ring: StagingRing, k: int, lo: int, n: int,
                        mesh: Mesh) -> _Chunk:
        """Queue block k's device work for this rank's chunk (its first frame
        `lo`): the upload, then each sub-step on its lane, its packed buffer
        all-gathered over the mesh and copied to the host. The record's
        frames are the block's."""
        decode, det_step, pose_step, _, court_step = steps
        lanes = self.lanes
        frames, ready = self._upload(ring, k, decode)
        block_lo = k * self.chunk * mesh.size
        n_real = min(block_lo + self.chunk * mesh.size, n) - block_lo

        def launch(lane, step) -> _Download:
            return self._launch(lane, step, frames, ready, gather=mesh.all_gather)

        return _Chunk(block_lo, n_real, launch(lanes.det, det_step), launch(lanes.pose, pose_step),
                      launch(lanes.ball, lambda f: ball_pre(f, lo)),
                      launch(lanes.court, court_step) if court_step else None)

    @traced("fused.drain")
    def _drain_block(self, chunk: _Chunk, builder: _ResultBuilder, src_hw,
                     pre_frames: list) -> None:
        """A block's host work, alike on every rank: the trackers' host
        halves and the IDs, then its preprocessed ball frames kept."""
        self._unpack_frames(builder, chunk, src_hw)
        pre, _ = chunk.ball.take(chunk.n_real)
        pre_frames.append(pre)

    # ------------------------------------------------------------------

    def _gather_setup(self, frame_iter, total_frames):
        """Median estimation over the head of the clip + the streaming frame
        window. Frames stay RGB for det/pose; the reference's channel quirk
        (the ball path sees the first median_max_sample_num frames
        channel-swapped) becomes per-frame flags that the ball branch reads
        on the device. The median and its model-resolution copy are handed
        on as tensors on the device, where the median was computed."""
        ball = self.ball
        subtract_mode = ball.bg_mode in ("subtract", "subtract_concat")
        buffered: list[np.ndarray] = []
        it = iter(frame_iter)
        quirk_upto = 0
        if ball.owns_median():
            for frame in it:
                buffered.append(frame)
                if len(buffered) == ball.median_max_sample_num:
                    break
            # Recomputed when the clip changed (first-frame fingerprint); the
            # quirk swap of the head frames applies on every run.
            if buffered:
                with tracer.span("ball.median"):
                    quirk = ball.ensure_median_for_clip(buffered)
                if quirk:
                    quirk_upto = len(buffered)
        elif subtract_mode and ball.median is None:
            raise ValueError(f"bg_mode={ball.bg_mode!r} needs a median")

        fw = _FrameWindow(buffered, it)
        seq_len = ball.tracknet_seq_len
        if fw.fill_to(seq_len) < seq_len or not len(fw):
            raise ValueError("clip shorter than seq_len")
        # Checked as the chunks are packed: a clip shorter than this raises.
        n = total_frames
        src_hw = tuple(fw.first().shape[:2])
        # Settle the run's wire format before anything derives from it.
        self._check_ingest(src_hw)
        quirk_flags = np.zeros(n, np.float32)
        quirk_flags[: min(quirk_upto, n)] = 1.0
        dev = self.device
        if ball.median is None:
            median_resized = torch.zeros((ball.HEIGHT, ball.WIDTH, 3), dtype=torch.uint8,
                                         device=dev)
        else:
            with tracer.span("ball.median"):
                median_resized = median_model_resolution(ball.device_median(), ball.HEIGHT,
                                                         ball.WIDTH, ball.bg_mode, dev)
        # Float median for the subtract modes' difference images on the
        # device, at the resolution they run at: the source (the median as
        # it was computed there), or the wire in the 'derived' ingest
        # (INTER_AREA on the host, as the frames).
        median_src = None
        if subtract_mode:
            wire_hw = self._wire(src_hw)[0]
            if wire_hw == src_hw:
                median_src = ball.device_median().to(dev, torch.float32)
            else:
                median_src = torch.from_numpy(
                    resize_area(ball.median.astype(np.float32), wire_hw)).to(dev)
        return median_resized, median_src, fw, quirk_flags, n, src_hw

