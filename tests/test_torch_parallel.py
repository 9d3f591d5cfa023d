"""The port's frame-axis data parallelism (padel_analytics_tpu_torch/parallel)
against the JAX package's.

`sharded_window_inference` runs on gloo process groups of 1, 2 and 4 CPU
ranks (child processes, tests/_torch_dist.py), in both stride modes and for
the 'concat' and 'subtract' background modes, with the windows in batches
of 4; its (x, y, visibility) must be BIT-EQUAL on every rank to the JAX
package's `sharded_window_inference` on a make_mesh(data=d) of the 8
virtual CPU devices, with the same decisive TrackNet stand-in (heatmaps of
0 and 1, so the ensemble's sums are exact on both sides). Also: the mesh's
refusals and its transfers with one rank, in this process."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist as td
from padel_analytics_tpu.config import BallTrackerConfig as JaxBallConfig
from padel_analytics_tpu.parallel.mesh import make_mesh as jax_make_mesh
from padel_analytics_tpu.parallel.sharded_inference import (
    sharded_window_inference as jax_sharded,
)
from padel_analytics_tpu.trackers import BallTracker as JaxBallTracker
from padel_analytics_tpu.utils.video import VideoInfo as JaxVideoInfo
from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    H,
    W,
    clip_frames,
    one_torch_thread,
)
from padel_analytics_tpu_torch.parallel import (
    Mesh,
    init_distributed,
    make_mesh,
    sharded_window_inference,
)

WORLDS = (1, 2, 4)
BALL_WORLDS = (1, 2)  # BallTracker(mesh=...)'s world sizes


class JaxMaxTrackNet:
    """MaxTrackNet (tests/_torch_dist.py) in jnp."""

    def __init__(self, bg_mode):
        self.net = td.MaxTrackNet(bg_mode)

    def __call__(self, x):
        first, c = self.net.first, self.net.c
        maps = [jnp.max(x[..., first + k * c: first + (k + 1) * c], axis=-1) > 0.5
                for k in range(self.net.seq_len)]
        return jnp.stack(maps, axis=-1).astype(jnp.float32)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """{world: [each rank's output directory]} from one child run per world
    size: the sharded and the ball cases together where port_balls takes
    the world too (1 and 2 ranks), the sharded alone at 4."""
    return {world: td.spawn("sharded_ball" if world in BALL_WORLDS else "sharded", world,
                            tmp_path_factory.mktemp(f"ranks{world}"))
            for world in WORLDS}


@pytest.fixture(scope="module")
def port_results(children):
    """{world: [each rank's {case: (3, N) int32}]}."""
    out = {}
    for world, dirs in children.items():
        dirs = [d / "sharded" if world in BALL_WORLDS else d for d in dirs]
        out[world] = [{case: np.load(d / f"{case[0]}_{case[1]}.npy") for case in td.SHARDED_CASES}
                      for d in dirs]
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("bg_mode,stride", td.SHARDED_CASES)
def test_sharded_window_inference_bit_equal_to_jax(port_results, world, bg_mode, stride):
    frames, median = td.sharded_clip(bg_mode)
    want = np.stack(jax_sharded(JaxMaxTrackNet(bg_mode), frames, median,
                                jax_make_mesh(data=world), seq_len=td.SEQ, bg_mode=bg_mode,
                                stride=stride))
    assert want.shape == (3, td.SHARD_N)
    assert 0 < want[2].sum() < td.SHARD_N  # visible and invisible frames both
    for rank, got in enumerate(port_results[world]):
        np.testing.assert_array_equal(got[(bg_mode, stride)], want, err_msg=f"rank {rank}")


@pytest.fixture(scope="module")
def port_balls(children):
    """{world: [each rank's {(n, stride): ball JSON}]}."""
    out = {}
    for world in BALL_WORLDS:
        dirs = [d / "ball" for d in children[world]]
        out[world] = [{case: json.loads((d / f"ball_{case[0]}_{case[1]}.json").read_text())
                       for case in td.BALL_CASES} for d in dirs]
    return out


def _as_json(balls):
    return json.loads(json.dumps(list(balls)))


@pytest.fixture(scope="module")
def single_balls():
    """{(n, stride): the port's single-device balls}, each checked against
    the JAX package's single-device BallTracker on the same frames (its own
    tests hold its mesh path to that one)."""
    from test_torch_ball_slice import JaxFakeTrackNet

    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a module fixture runs before one_torch_thread
    try:
        for n, stride in td.BALL_CASES:
            out[n, stride] = _single_ball(JaxFakeTrackNet, n, stride)
    finally:
        torch.set_num_threads(threads)
    return out


def _single_ball(fake, n, stride):
    """The port's single-device balls, held against the JAX package's."""
    frames = clip_frames(np.random.default_rng(3), n=n)
    ball = JaxBallTracker(None, None, compute_dtype=jnp.float32,
                          config=JaxBallConfig(height=72, width=128, batch_size=4,
                                               median_max_sample_num=6, window_stride=stride))
    ball.tracknet.model = fake()
    ball.video_info_post_init(JaxVideoInfo(width=W, height=H, fps=10.0, total_frames=n))
    want = _as_json(b.serialize() for b in ball.predict_frames(iter(frames), total_frames=n))
    got = _as_json(b.serialize() for b in td.ball_tracker(n, stride).predict_frames(
        iter(frames), total_frames=n))
    assert got == want, (n, stride)
    assert sum(b["visibility"] for b in got) > n // 2
    return got


@pytest.mark.parametrize("world", BALL_WORLDS)
@pytest.mark.parametrize("n,stride", td.BALL_CASES)
def test_ball_tracker_mesh_equals_jax_and_single_device(port_balls, single_balls, world, n,
                                                        stride):
    """BallTracker(mesh=...) on every rank: the single-device balls, which
    are the JAX package's, exactly. A clip too short for the halo (12
    frames on two ranks) takes the single-device path; the JAX package's
    takes it with the clip's first frame alone (ROADMAP.md Queue 3)."""
    for got in port_balls[world]:
        assert got[(n, stride)] == single_balls[n, stride]


@pytest.fixture()
def world_of_one():
    """A gloo group of this process alone, destroyed after the test."""
    init_distributed("cpu", rank=0, world_size=1, timeout_s=60,
                     init_method=f"tcp://127.0.0.1:{td.free_port()}")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_of_one_rank(world_of_one):
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    t = torch.arange(6).reshape(3, 2)
    # One rank: the ring is the identity (no transfer) and the gather a copy.
    assert mesh.ring_shift(t, 1) is t and torch.equal(mesh.all_gather(t), t)
    # A (data, model) mesh needs data * model ranks, one a device.
    with pytest.raises(ValueError, match="data=1 x model=2 needs 2 ranks.*has 1 ranks"):
        make_mesh(data=1, model=2, device="cpu")
    with pytest.raises(ValueError, match="1 ranks"):
        make_mesh(data=2, device="cpu")
    # A card is asked for where there is none: no fallback to the CPU.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    # A clip shorter than the halo needs is refused, as in the JAX package.
    frames, median = td.sharded_clip("concat")
    with pytest.raises(ValueError, match="shorter than seq_len"):
        sharded_window_inference(td.MaxTrackNet("concat"), frames[:5], median, mesh)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(device="cpu")


def test_init_distributed_reads_torchrun_environment(monkeypatch):
    """rank, world size and address from torchrun's variables; a second
    call keeps the group."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(td.free_port()))
    init_distributed("cpu", timeout_s=42)
    try:
        group = dist.group.WORLD
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        init_distributed("cpu")  # already joined: no second group
        assert dist.group.WORLD is group
        assert isinstance(make_mesh(device="cpu"), Mesh)
    finally:
        dist.destroy_process_group()
