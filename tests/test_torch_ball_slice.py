"""The ported ball path end to end against the JAX package: TrackingRunner
over one BallTracker (render=False, collect_data=False) on a tiny clip
written with cv2, in both packages.

Random-weight heatmaps hover at the 0.5 threshold, where summation order
legitimately flips the decode; so the cache-level comparison plugs the same
decisive fake TrackNet into both and requires BYTE-IDENTICAL ball JSON
caches. A second case runs the real TrackNet at fp32 with bridged weights
and holds the ensembled heatmaps of every chunk within 1e-4 abs.
`BallTracker(use_inpaintnet=False)` with an InpaintNet checkpoint (seeded
weights) gives the JAX package's cache with the same flag, byte for byte,
and the fused pipeline then streams, as with no inpaint path."""

import inspect

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import padel_analytics_tpu.trackers.ball as jax_ball
import padel_analytics_tpu_torch.trackers.ball as port_ball
from padel_analytics_tpu.config import BallTrackerConfig as JaxBallConfig
from padel_analytics_tpu.trackers.ball import BallTracker as JaxBallTracker
from padel_analytics_tpu.trackers.runner import TrackingRunner as JaxRunner
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.models.convert import tracknet_state_dict_from_flax
from padel_analytics_tpu_torch.ops.median import median_background
from padel_analytics_tpu_torch.trackers import BallTracker, TrackingRunner
from padel_analytics_tpu_torch.trackers._ballwindow import median_model_resolution
from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    BrightTrackNet,
    caches,
    clip_frames,
    make_trackers,
    one_torch_thread,
)
from _torch_helpers import random_jax_tracknet
from padel_analytics_tpu_torch.trackers import FusedPipeline
from test_torch_inpaint import write_checkpoint

W, H = 128, 96
HEATMAP_ATOL = 1e-4


def _write_clip(rng, path, n, gaps=()):
    """A bright ball crossing a dark noisy frame, absent in the frames `gaps`."""
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
    for i in range(n):
        f = np.full((H, W, 3), 30, np.uint8)
        x0 = 10 + (4 * i) % 100
        if i not in gaps:
            f[40:50, x0: x0 + 6] = 220
        f += rng.integers(0, 10, f.shape, dtype=np.uint8)
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


class JaxFakeTrackNet:
    """Heatmap = decisive indicator of bright pixels per window frame."""

    def apply(self, variables, x):
        maps = [(jnp.mean(x[..., 3 + 3 * c: 6 + 3 * c], axis=-1) > 0.6).astype(jnp.float32)
                for c in range(8)]
        return jnp.stack(maps, axis=-1)


class PortFakeTrackNet(torch.nn.Module):
    def forward(self, x):
        maps = [(x[..., 3 + 3 * c: 6 + 3 * c].mean(dim=-1) > 0.6).float() for c in range(8)]
        return torch.stack(maps, dim=-1)


def _run_both(tmp_path, clip, height, width, median_max, jax_model, port_model, port_sd=None):
    jax_tracker = JaxBallTracker(
        None, None, compute_dtype=jnp.float32, save_path=tmp_path / "jax_ball.json",
        config=JaxBallConfig(height=height, width=width, batch_size=4,
                             median_max_sample_num=median_max),
    )
    if callable(jax_model):
        jax_tracker.tracknet.variables = jax_model(jax_tracker)
    else:
        jax_tracker.tracknet.model = jax_model
    port_tracker = BallTracker(
        None, compute_dtype=torch.float32, save_path=tmp_path / "port_ball.json", device="cpu",
        config=BallTrackerConfig(height=height, width=width, batch_size=4,
                                 median_max_sample_num=median_max),
    )
    if port_sd is not None:
        port_tracker.tracknet.model.load_state_dict(port_sd)
    if port_model is not None:
        port_tracker.tracknet.model = port_model
    JaxRunner([jax_tracker], clip, tmp_path / "jax.mp4", render=False,
              collect_data=False).run()
    runner = TrackingRunner([port_tracker], clip, tmp_path / "port.mp4", render=False,
                            collect_data=False)
    runner.run()
    assert "ball_tracker" in runner.stage_times
    return jax_tracker, port_tracker


def test_ball_cache_byte_identical_with_fake_tracknet(rng, tmp_path):
    n = 26
    clip = tmp_path / "clip.mp4"
    _write_clip(rng, clip, n)
    _run_both(tmp_path, clip, 72, 128, 6, JaxFakeTrackNet(), PortFakeTrackNet())
    jax_bytes = (tmp_path / "jax_ball.json").read_bytes()
    port_bytes = (tmp_path / "port_ball.json").read_bytes()
    assert port_bytes == jax_bytes
    balls = BallTracker(None, load_path=tmp_path / "port_ball.json",
                        compute_dtype=torch.float32, device="cpu").results
    assert len(balls) == n
    assert sum(b.visibility for b in balls) > n // 2  # the fake sees the ball


def test_ball_heatmaps_match_with_real_tracknet(rng, tmp_path, monkeypatch):
    n = 12
    clip = tmp_path / "clip.mp4"
    _write_clip(rng, clip, n)
    _, _, variables = random_jax_tracknet(rng, hw=(32, 64))

    jax_heat, port_heat = [], []
    jax_decode, port_decode = jax_ball.decode_heatmaps, port_ball.decode_heatmaps

    def jax_record(ens):
        jax.debug.callback(lambda e: jax_heat.append(np.asarray(e)), ens)
        return jax_decode(ens)

    def port_record(ens):
        port_heat.append(ens.numpy().copy())
        return port_decode(ens)

    monkeypatch.setattr(jax_ball, "decode_heatmaps", jax_record)
    monkeypatch.setattr(port_ball, "decode_heatmaps", port_record)
    jax_tracker, port_tracker = _run_both(
        tmp_path, clip, 32, 64, 5,
        lambda t: jax.tree_util.tree_map(jnp.asarray, variables), None,
        port_sd=tracknet_state_dict_from_flax(variables),
    )
    assert len(jax_tracker.results) == len(port_tracker.results) == n
    assert len(port_heat) == len(jax_heat) == -(-(n + 7) // 4)
    for a, b in zip(port_heat, jax_heat):
        np.testing.assert_allclose(a, b, rtol=0, atol=HEATMAP_ATOL)


def _ball_cache(tmp_path, clip, name, jax: bool, **kwargs) -> bytes:
    """The decisive fake's ball cache from one per-tracker run."""
    config = dict(height=72, width=128, batch_size=4, median_max_sample_num=6)
    path = tmp_path / f"{name}.json"
    if jax:
        tracker = JaxBallTracker(None, compute_dtype=jnp.float32, save_path=path,
                                 config=JaxBallConfig(**config), **kwargs)
        tracker.tracknet.model = JaxFakeTrackNet()
        JaxRunner([tracker], clip, tmp_path / f"{name}.mp4", render=False,
                  collect_data=False).run()
        assert tracker.inpaintnet is None
    else:
        tracker = BallTracker(None, compute_dtype=torch.float32, save_path=path, device="cpu",
                              config=BallTrackerConfig(**config), **kwargs)
        tracker.tracknet.model = PortFakeTrackNet()
        TrackingRunner([tracker], clip, tmp_path / f"{name}.mp4", render=False,
                       collect_data=False).run()
        assert (tracker.inpaintnet is None) == (not kwargs.get("use_inpaintnet", True)
                                                or not kwargs.get("inpainting_model_path"))
    return path.read_bytes()


def test_use_inpaintnet_false_equals_jax(rng, tmp_path):
    """With an InpaintNet checkpoint and use_inpaintnet=False, no InpaintNet
    is built: the cache is the JAX package's with the same flag and the
    port's own with no inpaint path; with the flag on, the clip's gap (the
    ball low on both sides of it) is inpainted and the cache differs."""
    n = 26
    clip = tmp_path / "clip.mp4"
    _write_clip(rng, clip, n, gaps=range(12, 16))
    inpaint = str(tmp_path / "inpaint.pt")
    write_checkpoint(rng, inpaint)
    off = dict(inpainting_model_path=inpaint, use_inpaintnet=False)
    want = _ball_cache(tmp_path, clip, "jax_off", True, **off)
    got = _ball_cache(tmp_path, clip, "port_off", False, **off)
    assert got == want
    assert _ball_cache(tmp_path, clip, "port_none", False) == got
    on = _ball_cache(tmp_path, clip, "port_on", False, inpainting_model_path=inpaint)
    balls = BallTracker(None, load_path=tmp_path / "port_off.json", device="cpu").results
    assert [b.visibility for b in balls[12:15]] == [0, 0, 0] and on != got


def test_fused_pipeline_streams_without_inpaintnet(rng, tmp_path):
    """The fused pipeline streams its results while it runs when the ball
    tracker has no InpaintNet, use_inpaintnet=False included, and holds them
    to the end with one; the caches without it are the path-less run's."""
    inpaint = str(tmp_path / "inpaint.pt")
    write_checkpoint(rng, inpaint)
    frames = clip_frames(np.random.default_rng(3))
    players, pose, plain, court = make_trackers()
    out = {}
    for name, kwargs in (("none", None), ("off", dict(use_inpaintnet=False)), ("on", {})):
        ball = plain
        if kwargs is not None:
            ball = BallTracker(None, inpaint, compute_dtype=torch.float32, device="cpu",
                               config=BallTrackerConfig(height=72, width=128, batch_size=4,
                                                        median_max_sample_num=6), **kwargs)
            ball.tracknet.model = BrightTrackNet()
            ball.video_info_post_init(plain.video_info)
        streamed = []
        players.restart()
        result = FusedPipeline(players, pose, ball, court, chunk=8).run(
            iter(frames), len(frames), stream=lambda *new: streamed.append(len(new[2])))
        out[name] = caches(result)
        assert sum(streamed) == (0 if name == "on" else len(frames)), name
    assert out["off"] == out["none"] and out["on"]["ball"] != out["none"]["ball"]


def test_runner_refuses_unported_passes(tmp_path, rng):
    clip = tmp_path / "clip.mp4"
    _write_clip(rng, clip, 2)
    tracker = BallTracker(None, compute_dtype=torch.float32, device="cpu",
                          config=BallTrackerConfig(height=16, width=32))
    # The staged scan, once refused, is taken; a negative chunk count is not.
    assert TrackingRunner([tracker], clip, tmp_path / "o.mp4", render=False, fused=True,
                          fused_staged=2).fused_staged == 2
    with pytest.raises(ValueError, match="fused_staged"):
        TrackingRunner([tracker], clip, tmp_path / "o.mp4", render=False, fused=True,
                       fused_staged=-1)
    with pytest.raises(ValueError, match="association"):
        TrackingRunner([tracker], clip, tmp_path / "o.mp4", render=False, fused=True,
                       fused_association="hungarian")
    # The 'derived' ingest, the nonoverlap stride and the device association
    # scan, once refused, are taken.
    for kwargs in ({"fused_ingest": "derived"}, {"fused_ball_stride": 8},
                   {"fused_association": "device"}):
        runner = TrackingRunner([tracker], clip, tmp_path / "o.mp4", render=False, fused=True,
                                **kwargs)
        assert runner.fused_ingest == kwargs.get("fused_ingest", "i420")
        assert runner.fused_association == kwargs.get("fused_association", "auto")


def test_formerly_unported_inpaintnet_runs(tmp_path, rng):
    """InpaintNet, which raised NotImplementedError before it was ported,
    loads from a reference checkpoint and runs through the per-tracker
    runner: one Ball a frame, the pass on; a name that is no .pt refuses."""
    from padel_analytics_tpu_torch.models.layers import lecun_normal_
    from padel_analytics_tpu_torch.models.tracknet import InpaintNet

    clip = tmp_path / "clip.mp4"
    _write_clip(rng, clip, 20)
    sd = lecun_normal_(InpaintNet(), torch.Generator().manual_seed(1)).state_dict()
    sd = {k.replace("bottleneck_1.", "buttleneck.conv_1.").replace(
        "bottleneck_2.", "buttleneck.conv_2."): v for k, v in sd.items()}
    torch.save({"model": sd, "param_dict": {"seq_len": 16}}, tmp_path / "inpaint.pt")
    tracker = BallTracker(None, compute_dtype=torch.float32, device="cpu",
                          config=BallTrackerConfig(height=16, width=32,
                                                   inpainting_model_path=str(tmp_path / "inpaint.pt")))
    assert tracker.inpaintnet is not None and tracker.inpaintnet_seq_len == 16
    TrackingRunner([tracker], clip, tmp_path / "o.mp4", render=False).run()
    assert [b.frame for b in tracker.results] == list(range(20))
    (tmp_path / "inpaint.bin").write_bytes(b"\0")  # neither a known suffix nor a directory
    with pytest.raises(ValueError, match="InpaintNet"):
        BallTracker(None, inpainting_model_path=str(tmp_path / "inpaint.bin"), device="cpu")


def test_short_clip_zero_fills(tmp_path, rng):
    clip = tmp_path / "clip.mp4"
    _write_clip(rng, clip, 5)
    tracker = BallTracker(None, compute_dtype=torch.float32, device="cpu",
                          config=BallTrackerConfig(height=16, width=32))
    TrackingRunner([tracker], clip, tmp_path / "o.mp4", render=False).run()
    assert [b.serialize() for b in tracker.results] == [
        {"frame": i, "xy": (0.0, 0.0), "visibility": 0, "projection": None} for i in range(5)
    ]


def test_entry_point_defaults_to_the_card():
    """BallTracker() targets the card unless the caller asks for the CPU;
    the device helpers under it take the tracker's device, with no default."""
    assert inspect.signature(BallTracker).parameters["device"].default == "cuda"
    for fn in (median_background, median_model_resolution):
        assert inspect.signature(fn).parameters["device"].default is inspect.Parameter.empty
