"""The port's multi-device fused path against the JAX package's run_mesh.

`FusedPipeline.run_mesh` and `TrackingRunner(mesh=...)` run on gloo process
groups of 1 and 2 CPU ranks (child processes, tests/_torch_dist.py) with the
decisive fakes of tests/_torch_fused_cases.py, and the JAX package's
run_mesh on a make_mesh(data=d) of the 8 virtual CPU devices with the same
fakes (tests/test_torch_fused_jax.py). On every rank: the ball BIT-EQUAL,
the boxes and keypoints within rtol 1e-5, atol 1e-3 px (the JAX package's
own bound between run_mesh and run, tests/test_fused_mesh.py), the track IDs
(the association scan under 'auto') equal. Also: only rank 0 writes files;
run_mesh equals the port's run with association='device'; and new weights
between two run_mesh calls change the result (nothing is cached by id)."""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist as td
from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    N,
    caches,
    clip_frames,
    make_trackers,
    one_torch_thread,
)
from padel_analytics_tpu.parallel.mesh import make_mesh as jax_make_mesh
from padel_analytics_tpu.trackers.fused import FusedPipeline as JaxFusedPipeline
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.parallel import init_distributed, make_mesh
from padel_analytics_tpu_torch.trackers import FusedPipeline, TrackingRunner
from padel_analytics_tpu_torch.utils.video import MemoryClip
from test_torch_fused_jax import jax_trackers  # noqa: F401  (a module fixture)

WORLDS = (1, 2)
CHUNK = 4


def _frames():
    return clip_frames(np.random.default_rng(3))  # the children's clip


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(case, world): [each rank's output directory]}, both cases from one
    child run per world size."""
    out = {}
    for world in WORLDS:
        dirs = td.spawn("fused_runner", world, tmp_path_factory.mktemp(f"mesh{world}"))
        for case in ("fused", "runner"):
            out[case, world] = [d / case for d in dirs]
    return out


@pytest.fixture(scope="module")
def jax_mesh_caches(jax_trackers):  # noqa: F811
    return {world: caches(JaxFusedPipeline(*jax_trackers(), chunk=CHUNK)
                          .run_mesh(iter(_frames()), N, jax_make_mesh(data=world)))
            for world in WORLDS}


def _assert_matches_jax(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want) == ["ball", "keypoints", "players", "players_keypoints"]
    assert got["ball"] == want["ball"] and got["keypoints"] == want["keypoints"]
    players_got, players_want = json.loads(got["players"]), json.loads(want["players"])
    assert len(players_got) == len(players_want) == N
    for f, (a, b) in enumerate(zip(players_got, players_want)):
        assert len(a) == len(b), f
        for p, q in zip(a, b):
            np.testing.assert_allclose(p["xyxy"], q["xyxy"], rtol=1e-5, atol=1e-3)
            assert p["id"] == q["id"], f
            assert abs(p["confidence"] - q["confidence"]) < 1e-5
    pose_got, pose_want = json.loads(got["players_keypoints"]), json.loads(want["players_keypoints"])
    assert len(pose_got) == len(pose_want) == N
    for f, (a, b) in enumerate(zip(pose_got, pose_want)):
        assert len(a) == len(b), f
        for p, q in zip(a, b):
            np.testing.assert_allclose([k["xy"] for k in p["player_keypoints"]],
                                       [k["xy"] for k in q["player_keypoints"]],
                                       rtol=1e-5, atol=1e-3)
    # The scan saw the figures and gave them lasting IDs.
    assert sum(map(len, players_got)) >= N
    assert len({p["id"] for frame in players_got for p in frame}) >= 2


@pytest.mark.parametrize("world", WORLDS)
def test_run_mesh_matches_jax_run_mesh(runs, jax_mesh_caches, world):
    for rank, d in enumerate(runs["fused", world]):
        got = json.loads((d / "caches.json").read_text())
        _assert_matches_jax(got, jax_mesh_caches[world])


@pytest.mark.parametrize("world", WORLDS)
def test_runner_mesh_matches_jax_and_only_rank0_writes(runs, jax_mesh_caches, world):
    dirs = runs["runner", world]
    for d in dirs:
        _assert_matches_jax(json.loads((d / "caches.json").read_text()), jax_mesh_caches[world])
        # Every rank collected the same data.
        assert (d / "report.csv").read_bytes() == (dirs[0] / "report.csv").read_bytes()
    written = sorted(p.name for p in (dirs[0] / "files").iterdir())
    assert written == ["ball.json", "court.json", "data.csv", "players.json", "pose.json"]
    assert (dirs[0] / "files" / "data.csv").read_bytes() == (dirs[0] / "report.csv").read_bytes()
    for d in dirs[1:]:
        assert not any((d / "files").iterdir())


@pytest.mark.parametrize("world", WORLDS)
def test_run_mesh_equals_run_with_the_scan(runs, world):
    want = caches(FusedPipeline(*make_trackers(), chunk=CHUNK, association="device")
                  .run(iter(_frames()), N))
    for d in runs["fused", world]:
        assert json.loads((d / "caches.json").read_text()) == want


@pytest.fixture()
def mesh_of_one():
    init_distributed("cpu", rank=0, world_size=1, timeout_s=60,
                     init_method=f"tcp://127.0.0.1:{td.free_port()}")
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_new_weights_change_run_mesh(mesh_of_one):
    """A real (tiny) TrackNet on the ball: its weights changed in place
    between two run_mesh calls change the ball, and restored restore it."""
    trackers = make_trackers(ball_config=BallTrackerConfig(height=16, width=32, batch_size=4,
                                                           median_max_sample_num=6))
    pipe = FusedPipeline(*trackers, chunk=CHUNK)
    predictor = trackers[2].tracknet.model.predictor
    frames = _frames()

    def ball():
        return caches(pipe.run_mesh(iter(frames), N, mesh_of_one))["ball"]

    first = ball()
    saved = predictor.bias.detach().clone()
    with torch.no_grad():
        predictor.bias.add_(50.0)  # every heatmap pixel above the threshold
    lit = ball()
    with torch.no_grad():
        predictor.bias.copy_(saved)
    assert lit != first
    assert all(b["visibility"] == 1 for b in json.loads(lit))
    assert ball() == first


def test_run_mesh_refuses_a_clip_shorter_than_a_window(mesh_of_one):
    pipe = FusedPipeline(*make_trackers(n=6), chunk=CHUNK)
    with pytest.raises(ValueError, match="shorter than seq_len"):
        pipe.run_mesh(iter(_frames()[:6]), 6, mesh_of_one)


def test_runner_mesh_keeps_the_stream_draw_off(mesh_of_one, tmp_path):
    runner = TrackingRunner(list(make_trackers()), MemoryClip(_frames(), fps=10.0),
                            tmp_path / "o.mp4", fused=True, render=False, fused_stream_draw=True,
                            mesh=mesh_of_one)
    assert runner.is_writer and not runner.fused_stream_draw
