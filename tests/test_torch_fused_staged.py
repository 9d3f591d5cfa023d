"""The port's staged fused path (`FusedPipeline.run_staged`,
`TrackingRunner(fused_staged=N)`) on the CPU against its own `run`, with
the decisive fakes of tests/_torch_fused_cases.py: the JSON caches must be
BYTE-IDENTICAL, on a clip that is not a multiple of a round. On the CPU the
lanes' round functions run eagerly; the same functions are what a card
captures into its graphs (tests/test_torch_cuda.py, chip_smoke.py phase
21). The comparison with the JAX package's run_staged is in
tests/test_torch_fused_staged_jax.py."""

import json
import random
import time

import numpy as np
import pytest
import torch

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    H,
    N,
    W,
    CellDetector,
    caches,
    clip_frames,
    make_trackers,
    model_court,
    one_torch_thread,
)
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.models.layers import lecun_normal_
from padel_analytics_tpu_torch.models.tracknet import InpaintNet
from padel_analytics_tpu_torch.trackers import BallTracker, FusedPipeline, TrackingRunner
from padel_analytics_tpu_torch.trackers._ballwindow import make_frame_preprocess
from padel_analytics_tpu_torch.utils.video import MemoryClip

#: Chunks a round in these tests: 12 frames a round at chunk 4, so the
#: 26-frame clip (33 with the ball's tail) takes three rounds, the last
#: part padding.
SUPERCHUNK = 3


def _case(name: str, tmp_path):
    """(trackers, FusedPipeline keyword arguments) of one staged case."""
    trackers = list(make_trackers())
    kwargs = {"chunk": 4}
    if name in ("i420", "derived"):
        kwargs.update(ingest=name, wire_long_side=64)
    elif name == "ball_stride=8":
        kwargs.update(chunk=8, ball_stride=8)
    elif name == "yolo court":
        trackers[3] = model_court("yolo")
        trackers[3].engine.model = CellDetector(pose=True, nk=12)
    elif name == "InpaintNet":
        path = tmp_path / "inpaint.pt"
        torch.save({"model": lecun_normal_(InpaintNet(), torch.Generator().manual_seed(2))
                    .state_dict(), "param_dict": {"seq_len": 16}}, path)
        ball = BallTracker(None, inpainting_model_path=str(path), compute_dtype=torch.float32,
                           device="cpu", config=BallTrackerConfig(
                               height=72, width=128, batch_size=4, median_max_sample_num=6))
        ball.tracknet.model = trackers[2].tracknet.model
        trackers[2] = ball.video_info_post_init(trackers[2].video_info)
    elif name == "device association":
        kwargs.update(association="device")
    return trackers, kwargs


@pytest.mark.parametrize("name", ["rgb", "i420", "derived", "ball_stride=8", "yolo court",
                                  "InpaintNet", "device association"])
def test_run_staged_equals_run(rng, tmp_path, name):
    frames = clip_frames(rng)
    trackers, kwargs = _case(name, tmp_path)
    want = caches(FusedPipeline(*trackers, **kwargs).run(iter(frames), N))
    trackers[0].restart()  # ByteTrack afresh
    pipe = FusedPipeline(*trackers, **kwargs)
    got = caches(pipe.run_staged(iter(frames), N, superchunk=SUPERCHUNK))
    assert sorted(got) == sorted(want) == ["ball", "keypoints", "players", "players_keypoints"]
    for key in want:
        assert got[key] == want[key], key
    assert all(len(json.loads(v)) == N for v in got.values())
    assert sum(b["visibility"] for b in json.loads(got["ball"])) > 0
    rows = pipe.chunk * SUPERCHUNK
    assert (N + pipe._ball_off) % rows  # the last round is part padding
    lanes = {"det", "pose", "ball"} | ({"court"} if name == "yolo court" else set())
    assert set(pipe.last_staged_graphs["replays"]) == lanes
    assert set(pipe.last_staged_split) == {"setup_s", "prep_wait_s", "upload_s", "dispatch_s",
                                           "assoc_s", "drain_s"}


@pytest.mark.parametrize("bg_mode", ["", "concat", "subtract", "subtract_concat"])
def test_zero_swap_flags_give_the_bits_of_none(rng, bg_mode):
    """The staged ball step always passes the round's flags: all-zero flags
    must give the bits of no flags, which `run` passes for such a chunk."""
    frames = torch.from_numpy(rng.integers(0, 256, (4, H, W, 3), dtype=np.uint8))
    median = torch.from_numpy(rng.uniform(0, 255, (H, W, 3)).astype(np.float32))
    pre = make_frame_preprocess((H, W), (36, 64), bg_mode)
    want = pre(frames, median_src=median, swap=None)
    got = pre(frames, median_src=median, swap=torch.zeros(4))
    assert torch.equal(got, want)
    assert not torch.equal(pre(frames, median_src=median, swap=torch.ones(4)), want)


def _jittery(frames, seed, max_delay=0.004):
    delays = random.Random(seed)
    for f in frames:
        if delays.random() < 0.4:
            time.sleep(delays.random() * max_delay)
        yield f


def test_staged_stream_sees_every_frame_once_in_order_under_jitter(rng):
    """A jittery frame iterator and a slow consumer: the callback, fed once
    a round, sees every frame once and in order, and the results are
    `run`'s."""
    frames = clip_frames(rng)
    trackers = make_trackers()
    want = caches(FusedPipeline(*trackers, chunk=4).run(iter(frames), N))
    trackers[0].restart()
    seen = {k: [] for k in ("players", "players_keypoints", "ball", "keypoints")}
    calls, delays = [], random.Random(1)

    def stream(*new):
        calls.append(len(new[0]))
        if delays.random() < 0.5:
            time.sleep(delays.random() * 0.01)
        for key, objs in zip(seen, new):
            seen[key] += objs

    out = FusedPipeline(*trackers, chunk=4).run_staged(
        _jittery(frames, 3), N, superchunk=SUPERCHUNK, stream=stream)
    assert [b.frame for b in seen["ball"]] == list(range(N))
    assert caches(seen) == caches(out) == want
    assert len(calls) <= -(-(N + 7) // (4 * SUPERCHUNK)) and all(calls)


def test_staged_refuses_a_dry_iterator(rng):
    frames = clip_frames(rng, n=20)
    pipe = FusedPipeline(*make_trackers(n=40), chunk=4)
    with pytest.raises(ValueError, match="ran dry after 20 frames of total_frames=40"):
        pipe.run_staged(iter(frames), total_frames=40, superchunk=SUPERCHUNK)
    out = pipe.run_staged(iter(frames), total_frames=20, superchunk=SUPERCHUNK)
    assert [len(v) for v in out.values()] == [20] * 4
    with pytest.raises(ValueError, match="superchunk"):
        pipe.run_staged(iter(frames), total_frames=20, superchunk=0)


def test_new_weights_change_run_staged(rng):
    """A real (tiny) TrackNet on the ball: its weights changed in place
    between two run_staged calls change the ball and rebuild the ball
    lane's graphs (both parities) and no other; restored, they restore it
    (the card's case, a folded BatchNorm changed, is in
    tests/test_torch_cuda.py)."""
    trackers = make_trackers(ball_config=BallTrackerConfig(height=16, width=32, batch_size=4,
                                                           median_max_sample_num=6))
    pipe = FusedPipeline(*trackers, chunk=4)
    model = trackers[2].tracknet.model
    frames = clip_frames(rng)

    def ball():
        return caches(pipe.run_staged(iter(frames), N, superchunk=SUPERCHUNK))["ball"]

    first = ball()
    assert pipe.last_staged_graphs["built"] == 6  # three lanes, two parities
    assert ball() == first and pipe.last_staged_graphs["built"] == 0
    saved = model.predictor.bias.detach().clone()
    with torch.no_grad():
        model.predictor.bias.add_(50.0)  # every heatmap pixel above the threshold
    lit = ball()
    assert pipe.last_staged_graphs["built"] == 2
    with torch.no_grad():
        model.predictor.bias.copy_(saved)
    assert lit != first
    assert all(b["visibility"] == 1 for b in json.loads(lit))
    assert ball() == first and pipe.last_staged_graphs["built"] == 2


def _runner_files(frames, out_dir, staged: int) -> dict[str, bytes]:
    out_dir.mkdir()
    trackers = [t for t in make_trackers(save_dir=out_dir) if t is not None]
    runner = TrackingRunner(trackers, MemoryClip(frames, fps=10.0), out_dir / "o.mp4",
                            fused=True, fused_chunk=4, fused_staged=staged, render=False,
                            collect_data=True)
    runner.run()
    assert "fused_inference" in runner.stage_times
    runner.write_csv(out_dir / "data.csv")
    return {p.name: p.read_bytes() for p in sorted(out_dir.iterdir()) if p.suffix != ".mp4"}


def test_runner_fused_staged_writes_the_same_files(rng, tmp_path):
    """TrackingRunner(fused_staged=2) writes the four caches and data.csv of
    fused_staged=0 byte for byte."""
    frames = clip_frames(rng)
    want = _runner_files(frames, tmp_path / "run", 0)
    got = _runner_files(frames, tmp_path / "staged", 2)
    assert sorted(got) == ["ball.json", "court.json", "data.csv", "players.json", "pose.json"]
    assert got == want


def test_runner_refuses_a_negative_fused_staged(rng):
    with pytest.raises(ValueError, match="fused_staged"):
        TrackingRunner(list(make_trackers()), MemoryClip(clip_frames(rng, n=2), fps=10.0),
                       "o.mp4", fused=True, render=False, fused_staged=-1)
