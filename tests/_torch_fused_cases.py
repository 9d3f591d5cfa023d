"""A tiny clip and decisive fake models for the port's fused-pipeline tests,
on the CPU (tests/test_torch_fused*.py) and on the card
(tests/test_torch_cuda.py). Imports no JAX.

Random-weight scores and heatmaps sit where summation order may flip a
threshold, so the cache-level comparisons plug in fakes whose outputs are
far from every threshold: a detector scoring 0.9 on each 8x8 cell of its
input that holds a bright pixel and 0.1 elsewhere, with boxes (and
keypoints) fixed around the cell centres, and a TrackNet whose heatmap is
the indicator of bright pixels of each window frame (the same fakes as
tests/test_torch_players_slice.py and tests/test_torch_ball_slice.py)."""

import json

import numpy as np
import pytest
import torch

from padel_analytics_tpu_torch.config import BallTrackerConfig, PlayersTrackerConfig
from padel_analytics_tpu_torch.ops.polygon import PolygonZone
from padel_analytics_tpu_torch.trackers import (
    BallTracker,
    Keypoint,
    Keypoints,
    KeypointsTracker,
    PlayerKeypointsTracker,
    PlayerTracker,
)
from padel_analytics_tpu_torch.trackers.court_keypoints import POINTS_MAPPER
from padel_analytics_tpu_torch.utils.video import VideoInfo

W, H, N = 128, 96, 26
IMGSZ = 64  # letterbox gain 0.5: 48x64 resized, padded to 64x64
BRIGHT = 0.61
# The court: rows below y = 50 (the bottom edge lies outside the frame).
POLYGON = np.array([[4, 100], [124, 100], [116, 50], [12, 50]], float)
COURT = [(20, 80), (108, 80), (22, 68), (64, 68), (106, 68), (25, 50),
         (103, 50), (28, 35), (64, 35), (100, 35), (30, 22), (98, 22)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread: the tiny ops of these tests gain
    nothing from threads, and the suite's parallel workers each starting a
    full thread pool oversubscribe the host (a test file that takes 16 s
    alone took 20 minutes beside five other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def clip_frames(rng, n: int = N, h: int = H, w: int = W) -> list[np.ndarray]:
    """Two bright figures walking on a dark noisy court, a third standing
    above it, and a bright ball crossing."""
    frames = []
    for i in range(n):
        f = np.full((h, w, 3), 30, np.uint8)
        for x0, y0, fh in ((10 + 3 * i, 40, 20), (100 - 2 * i, 50, 20), (60, 2, 10)):
            f[y0: y0 + fh, x0: x0 + 8] = 220
        xb = 10 + (4 * i) % 100
        f[25:31, xb: xb + 6] = 230
        f += rng.integers(0, 10, f.shape, dtype=np.uint8)
        frames.append(f)
    return frames


def cell_geometry(h: int, w: int, pose: bool, nk: int = 13) -> dict[str, np.ndarray]:
    """Integer boxes (and nk keypoints) around the centres of the 8x8 cells
    of an (h, w) model input, so every value is exact in float32. The 13
    pose keypoints lie on a line; the court's 12 (nk = 12) are COURT's shape
    around the cell centre, keypoint k where the court id POINTS_MAPPER[k]
    lies, so a homography from them is a court's."""
    cy, cx = np.mgrid[0: h // 8, 0: w // 8].reshape(2, -1) * 8.0 + 4.0
    out = {"boxes": np.stack([cx - 6, cy - 10, cx + 6, cy + 14], -1)}
    if pose and nk == 12:
        offsets = np.array([COURT[POINTS_MAPPER[k]] for k in range(12)], float) - (64, 51)
        out["kpts"] = np.stack([cx[:, None] + offsets[:, 0], cy[:, None] + offsets[:, 1],
                                np.full((cx.size, nk), 0.5)], -1)
    elif pose:
        k = np.arange(nk)
        out["kpts"] = np.stack([cx[:, None] + k, cy[:, None] + 2 * k,
                                np.full((cx.size, nk), 0.5)], -1)
    return {k: v.astype(np.float32) for k, v in out.items()}


class CellDetector(torch.nn.Module):
    """Score 0.9 where an 8x8 cell of the input holds a bright pixel (the
    brightest channel, an exact maximum), else 0.1; with `pose`, `nk`
    keypoints a cell (13 for the players' pose, 12 for the court). The
    geometry is uploaded once per input size and device: an upload from
    pageable memory inside a forward would synchronise the host with the
    card and hide a race between the fused pipeline's streams."""

    def __init__(self, pose: bool, nk: int = 13):
        super().__init__()
        self.pose = pose
        self.nk = nk
        self._geometry: dict = {}

    def forward(self, x):
        b, h, w, _ = x.shape
        key = (h, w, x.device)
        if key not in self._geometry:
            self._geometry[key] = {k: torch.from_numpy(v).to(x.device)
                                   for k, v in cell_geometry(h, w, self.pose, self.nk).items()}
        cells = x.amax(dim=-1).reshape(b, h // 8, 8, w // 8, 8).amax(dim=(2, 4))
        out = {k: v.expand(b, *v.shape) for k, v in self._geometry[key].items()}
        out["scores"] = torch.where(cells.reshape(b, -1, 1) > BRIGHT, 0.9, 0.1).float()
        return out


class BrightTrackNet(torch.nn.Module):
    """Heatmap = indicator of bright pixels of each of the 8 window frames
    ('concat' windows: the median's 3 channels first)."""

    def forward(self, x):
        maps = [(x[..., 3 + 3 * c: 6 + 3 * c].float().mean(dim=-1) > 0.6).float()
                for c in range(8)]
        return torch.stack(maps, dim=-1)


def make_trackers(device="cpu", n: int = N, batch: int = 4, save_dir=None, court: bool = True,
                  ball_config: BallTrackerConfig | None = None, fps: float = 10.0):
    """(players, pose, ball, court) at the tiny size, fakes plugged in, the
    video info set; JSON caches under `save_dir` when given."""
    def save(name):
        return None if save_dir is None else save_dir / f"{name}.json"

    players = PlayerTracker(
        None, PolygonZone(POLYGON), compute_dtype=torch.float32, device=device,
        save_path=save("players"),
        config=PlayersTrackerConfig(imgsz=IMGSZ, model_variant="n", batch_size=batch),
    )
    pose = PlayerKeypointsTracker(None, train_image_size=IMGSZ, batch_size=batch,
                                  model_variant="n", compute_dtype=torch.float32,
                                  device=device, save_path=save("pose"))
    ball = BallTracker(None, compute_dtype=torch.float32, device=device, save_path=save("ball"),
                       config=ball_config or BallTrackerConfig(
                           height=72, width=128, batch_size=batch, median_max_sample_num=6))
    players.engine.model = CellDetector(pose=False)
    pose.engine.model = CellDetector(pose=True)
    if ball_config is None:
        ball.tracknet.model = BrightTrackNet()
    trackers = [players, pose, ball]
    if court:
        trackers.append(KeypointsTracker(fixed_keypoints_detection=court_keypoints(),
                                         save_path=save("court")))
    info = VideoInfo(width=W, height=H, fps=fps, total_frames=n)
    for t in trackers:
        t.video_info_post_init(info)
    return tuple(trackers) if court else (*trackers, None)


#: The model court's input sizes in these tests ('yolo' squash, 'resnet').
COURT_YOLO_SIZE, COURT_RESNET_SIZE = 64, 32
#: Frames of `court_clip` with nothing bright in them: no court clears conf.
BLANK = (5, 6, 17)


def court_clip(rng, n: int = N) -> list[np.ndarray]:
    """clip_frames without the figure standing above the court (its rows
    dark), so the first bright cell, whose candidate the court fake keeps,
    is the crossing ball's and the court moves from frame to frame; the
    frames of BLANK dark throughout."""
    frames = clip_frames(rng, n)
    for k, f in enumerate(frames):
        rows = slice(0, H) if k in BLANK else slice(0, 16)
        f[rows] = 30 + rng.integers(0, 10, f[rows].shape, dtype=np.uint8)
    return frames


def model_court(mode: str, device="cpu", batch: int = 4, n: int = N,
                compute_dtype: torch.dtype = torch.float32, **kwargs) -> KeypointsTracker:
    """A model court ('yolo': YOLOv8n-pose with 12 keypoints at a 64 squash;
    'resnet': ResNet-50 at 32), fp32 unless told (K1 takes bf16 on the
    card), the video info set. For 'yolo' the tests plug in
    CellDetector(pose=True, nk=12)."""
    class Small(KeypointsTracker):
        TRAIN_IMAGE_SIZE = COURT_YOLO_SIZE
        RESNET_SIZE = COURT_RESNET_SIZE

    t = Small(None, batch_size=batch, model_type=mode, model_variant="n",
              compute_dtype=compute_dtype, device=device, **kwargs)
    return t.video_info_post_init(VideoInfo(width=W, height=H, fps=10.0, total_frames=n))


def court_keypoints() -> Keypoints:
    return Keypoints([Keypoint(id=i, xy=(float(x), float(y))) for i, (x, y) in enumerate(COURT)])


def per_tracker(players, pose, ball, frames, batch: int = 4) -> dict[str, str]:
    """JSON of the per-tracker paths' predictions over `frames`."""
    sep_players, sep_pose = [], []
    for lo in range(0, len(frames), batch):
        sample = np.stack(frames[lo: lo + batch])
        sep_players += players.predict_sample(sample)
        sep_pose += pose.predict_sample(sample)
    sep_ball = ball.predict_frames(iter(frames), total_frames=len(frames))
    return caches({"players": sep_players, "players_keypoints": sep_pose, "ball": sep_ball})


def caches(out: dict[str, list]) -> dict[str, str]:
    """Each result list as the JSON its tracker's cache would hold."""
    return {k: json.dumps([o.serialize() for o in v]) for k, v in out.items()}
