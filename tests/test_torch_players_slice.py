"""The ported players and pose paths end to end against the JAX package:
TrackingRunner over one PlayerTracker (letterbox, YOLOv8, NMS, unletterbox,
polygon gate, ByteTrack) or one PlayerKeypointsTracker (PIL squash,
YOLOv8-pose, NMS, keypoint gather) on a tiny clip written with cv2, in both
packages.

Random-weight scores sit where summation order may flip a threshold, so the
cache-level comparison plugs the same decisive fake detector into both and
requires BYTE-IDENTICAL players and pose JSON caches. A second case runs the
real YOLOv8 (variant n) at fp32 with bridged weights and holds the model's
outputs on every chunk within 1e-4 of their largest magnitude (measured
~1e-6; the letterbox and the squash are fp32 matmuls in another summation
order as well)."""

import inspect

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.config import PlayersTrackerConfig as JaxPlayersConfig
from padel_analytics_tpu.ops.polygon import PolygonZone as JaxPolygonZone
from padel_analytics_tpu.trackers.player_keypoints import (
    PlayerKeypointsTracker as JaxPoseTracker,
)
from padel_analytics_tpu.trackers.players import PlayerTracker as JaxPlayerTracker
from padel_analytics_tpu.trackers.runner import TrackingRunner as JaxRunner
from padel_analytics_tpu_torch.config import PlayersTrackerConfig
from padel_analytics_tpu_torch.models.convert import state_dict_from_flax
from padel_analytics_tpu_torch.ops.polygon import PolygonZone
from padel_analytics_tpu_torch.trackers import (
    PlayerKeypointsTracker,
    Players,
    PlayersKeypoints,
    PlayerTracker,
    TrackingRunner,
)
from _torch_helpers import random_jax_yolov8

W, H = 128, 96
IMGSZ = 64  # letterbox gain 0.5: 48x64 resized, padded to 64x64
REL_TOL = 1e-4
# The court: rows below y = 50 (the bottom edge lies outside the frame).
POLYGON = np.array([[4, 100], [124, 100], [116, 50], [12, 50]], float)


def _write_clip(rng, path, n):
    """Two bright figures walking on a dark noisy court, a third standing
    above it."""
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
    for i in range(n):
        f = np.full((H, W, 3), 30, np.uint8)
        for x0, y0, h in ((10 + 3 * i, 40, 20), (100 - 2 * i, 50, 20), (60, 2, 10)):
            f[y0: y0 + h, x0: x0 + 8] = 220
        f += rng.integers(0, 10, f.shape, dtype=np.uint8)
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def _cell_geometry(h, w, pose):
    """Integer boxes (and keypoints) around the centres of the 8x8 cells of
    an (h, w) model input, so every value is exact in float32."""
    cy, cx = np.mgrid[0: h // 8, 0: w // 8].reshape(2, -1) * 8.0 + 4.0
    out = {"boxes": np.stack([cx - 6, cy - 10, cx + 6, cy + 14], -1)}
    if pose:
        k = np.arange(13)
        out["kpts"] = np.stack([cx[:, None] + k, cy[:, None] + 2 * k,
                                np.full((cx.size, 13), 0.5)], -1)
    return {k: v.astype(np.float32) for k, v in out.items()}


# A decisive detector: score 0.9 where an 8x8 cell of the model input holds
# a bright pixel (the brightest channel, an exact maximum), else 0.1.
BRIGHT = 0.61


class JaxFake:
    def __init__(self, pose):
        self.pose = pose

    def apply(self, variables, x):
        b, h, w, _ = x.shape
        cells = jnp.max(x, axis=-1).reshape(b, h // 8, 8, w // 8, 8).max(axis=(2, 4))
        out = {k: jnp.broadcast_to(jnp.asarray(v), (b, *v.shape))
               for k, v in _cell_geometry(h, w, self.pose).items()}
        out["scores"] = jnp.where(cells.reshape(b, -1, 1) > BRIGHT, 0.9, 0.1).astype(jnp.float32)
        return out


class PortFake(torch.nn.Module):
    def __init__(self, pose):
        super().__init__()
        self.pose = pose

    def forward(self, x):
        b, h, w, _ = x.shape
        cells = x.amax(dim=-1).reshape(b, h // 8, 8, w // 8, 8).amax(dim=(2, 4))
        out = {k: torch.from_numpy(v).expand(b, *v.shape)
               for k, v in _cell_geometry(h, w, self.pose).items()}
        out["scores"] = torch.where(cells.reshape(b, -1, 1) > BRIGHT, 0.9, 0.1)
        return out


def _trackers(kind, tmp_path):
    if kind == "players":
        jax_t = JaxPlayerTracker(
            None, JaxPolygonZone(POLYGON), compute_dtype=jnp.float32,
            save_path=tmp_path / "jax.json",
            config=JaxPlayersConfig(imgsz=IMGSZ, model_variant="n", batch_size=4),
        )
        port_t = PlayerTracker(
            None, PolygonZone(POLYGON), compute_dtype=torch.float32, device="cpu",
            save_path=tmp_path / "port.json",
            config=PlayersTrackerConfig(imgsz=IMGSZ, model_variant="n", batch_size=4),
        )
    else:
        jax_t = JaxPoseTracker(
            None, train_image_size=IMGSZ, batch_size=4, model_variant="n",
            compute_dtype=jnp.float32, save_path=tmp_path / "jax.json",
        )
        port_t = PlayerKeypointsTracker(
            None, train_image_size=IMGSZ, batch_size=4, model_variant="n",
            compute_dtype=torch.float32, device="cpu", save_path=tmp_path / "port.json",
        )
    return jax_t, port_t


def _run_both(tmp_path, clip, jax_t, port_t):
    JaxRunner([jax_t], clip, tmp_path / "jax.mp4", render=False, collect_data=False).run()
    runner = TrackingRunner([port_t], clip, tmp_path / "port.mp4", render=False,
                            collect_data=False)
    runner.run()
    assert str(port_t) in runner.stage_times


@pytest.mark.parametrize("kind", ["players", "pose"])
def test_cache_byte_identical_with_fake_detector(rng, tmp_path, kind):
    n = 14
    clip = tmp_path / "clip.mp4"
    _write_clip(rng, clip, n)
    jax_t, port_t = _trackers(kind, tmp_path)
    jax_t.engine.model = JaxFake(kind == "pose")
    port_t.engine.model = PortFake(kind == "pose")
    _run_both(tmp_path, clip, jax_t, port_t)
    port_bytes = (tmp_path / "port.json").read_bytes()
    assert port_bytes == (tmp_path / "jax.json").read_bytes()

    cls = PlayerTracker if kind == "players" else PlayerKeypointsTracker
    args = (None, None) if kind == "players" else (None,)
    loaded = cls(*args, model_variant="n", device="cpu", load_path=tmp_path / "port.json").results
    assert len(loaded) == n
    assert all(isinstance(p, Players if kind == "players" else PlayersKeypoints) for p in loaded)
    total = sum(len(p) for p in loaded)
    assert total >= n  # the fake sees the figures
    if kind == "players":
        ids = {pl.id for p in loaded for pl in p}
        assert min(ids) >= 1 and len(ids) >= 3
        # The gate dropped the figure above the court (its boxes end at y = 36).
        assert all(pl.xyxy[3] > 50 for p in loaded for pl in p)
    else:
        assert all(len(pk) == 13 for p in loaded for pk in p)


@pytest.mark.parametrize("kind", ["players", "pose"])
def test_model_outputs_match_with_real_yolov8(rng, tmp_path, kind):
    n = 6
    clip = tmp_path / "clip.mp4"
    _write_clip(rng, clip, n)
    _, variables = random_jax_yolov8(rng, "n", 1, 13 if kind == "pose" else 0, hw=(IMGSZ, IMGSZ))
    jax_t, port_t = _trackers(kind, tmp_path)
    jax_t.engine.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    port_t.engine.model.load_state_dict(state_dict_from_flax(variables))

    jax_out, port_out = [], []
    real_jax, real_port = jax_t.engine.model, port_t.engine.model

    class JaxRecorder:
        def apply(self, v, x):
            out = real_jax.apply(v, x)
            jax.debug.callback(lambda o: jax_out.append({k: np.asarray(a) for k, a in o.items()}),
                               out)
            return out

    class PortRecorder(torch.nn.Module):
        def forward(self, x):
            out = real_port(x)
            port_out.append({k: v.numpy().copy() for k, v in out.items()})
            return out

    jax_t.engine.model = JaxRecorder()
    port_t.engine.model = PortRecorder()
    _run_both(tmp_path, clip, jax_t, port_t)
    assert len(jax_out) == len(port_out) == 2  # chunks of 4: 4 + 2 frames
    for got, want in zip(port_out, jax_out):
        assert set(got) == set(want)
        for k in got:
            m = got[k].shape[0]  # the JAX side pads the last chunk
            err = float(np.abs(got[k] - want[k][:m]).max())
            assert err <= REL_TOL * float(np.abs(want[k]).max()) + 1e-6, (k, err)
    assert len(port_t.results) == len(jax_t.results) == n


def test_entry_points_default_to_the_card():
    for cls in (PlayerTracker, PlayerKeypointsTracker):
        params = inspect.signature(cls).parameters
        assert params["device"].default == "cuda" and params["seed"].default == 0
