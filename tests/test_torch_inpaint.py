"""The port's InpaintNet and the ball tracker's inpaint pass against the JAX
package, on the same seeded inputs and the same weights (a reference-format
checkpoint both packages load).

- InpaintNet in fp32 within 1e-6 of the JAX model (both sum 3-tap conv1d
  windows; measured ~1e-7);
- the checkpoint loaders: the port's `convert_inpaintnet_checkpoint` equals
  the JAX package's converter followed by the Flax bridge, tensor for tensor;
- `generate_inpaint_mask`, a host numpy copy, equal on generated visibility
  patterns;
- the inpaint pass (`_inpaint_pass`) against the JAX package's on clips
  shorter than the window, as long as it and longer than the JAX package's
  64-window chunk, with a gap at the head and one inside. The port runs every
  window in one call where the JAX package runs chunks of 64. The ensemble's
  floats (captured from the JAX step) agree within ENS_TOL (measured
  1.8e-7). The denormalised ints are equal wherever the product lies more
  than the tolerance from an integer edge. A frame that was not inpainted
  holds the ensemble of L equal integer coordinates, whose fp32 sum lands
  within a few ulp of the integer itself: there int() follows the last ulp,
  which XLA's CPU code (fused multiply-adds in some lanes, plain products in
  others) decides differently from the port's plain products summed in j
  order. At those edges, and only there, the ints may differ by one; the
  test asserts that every unequal int is such an edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu.config import BallTrackerConfig as JaxBallConfig
from padel_analytics_tpu.models.convert import (
    convert_inpaintnet_checkpoint as jax_convert_inpaintnet_checkpoint,
)
from padel_analytics_tpu.models.tracknet import InpaintNet as JaxInpaintNet
from padel_analytics_tpu.trackers.ball import BallTracker as JaxBallTracker
from padel_analytics_tpu.trackers.ball import generate_inpaint_mask as jax_generate_inpaint_mask
from padel_analytics_tpu.utils.video import VideoInfo as JaxVideoInfo
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.models.convert import (
    convert_inpaintnet_checkpoint,
    state_dict_from_flax,
)
from padel_analytics_tpu_torch.models.tracknet import InpaintNet
from padel_analytics_tpu_torch.trackers import BallTracker
from padel_analytics_tpu_torch.trackers.ball import generate_inpaint_mask
from padel_analytics_tpu_torch.utils.video import VideoInfo

NET_ATOL = 1e-6
# Normalised units; x1279 / x719 in pixels.
ENS_TOL = 1e-6
# Non-round source dims: with integer coordinates on round dims the
# denormalised products land exactly on integers.
W, H = 1279, 719


def random_inpaint_variables(rng) -> dict:
    """A random JAX InpaintNet variable tree: N(0, 1/fan_in) kernels, biases
    N(0, 0.1)."""
    shapes = jax.eval_shape(JaxInpaintNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 2)), jnp.zeros((1, 16, 1)))

    def fill(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray,
                                  dict(jax.tree_util.tree_map_with_path(fill, shapes)))


def reference_checkpoint(variables, seq_len: int = 16) -> dict:
    """The variables as the reference saves InpaintNet: {'model': state_dict
    under its names ('buttleneck.conv_k'), 'param_dict': {'seq_len': ...}}."""
    sd = {}
    for key, value in state_dict_from_flax(variables).items():
        for i in (1, 2):
            key = key.replace(f"bottleneck_{i}.", f"buttleneck.conv_{i}.")
        sd[key] = value
    return {"model": sd, "param_dict": {"seq_len": seq_len}}


def write_checkpoint(rng, path, seq_len: int = 16):
    variables = random_inpaint_variables(rng)
    torch.save(reference_checkpoint(variables, seq_len), path)
    return variables


def test_inpaintnet_fp32_equals_jax(rng):
    variables = random_inpaint_variables(rng)
    coords = rng.uniform(0, 1, (5, 16, 2)).astype(np.float32)
    mask = rng.integers(0, 2, (5, 16, 1)).astype(np.float32)
    want = np.asarray(JaxInpaintNet().apply(variables, jnp.asarray(coords), jnp.asarray(mask)))
    net = InpaintNet()
    net.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(coords), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (5, 16, 2) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= NET_ATOL


def test_checkpoint_loaders_equal(rng):
    ckpt = reference_checkpoint(random_inpaint_variables(rng), seq_len=12)
    assert "buttleneck.conv_2.conv.weight" in ckpt["model"]
    port_sd, port_params = convert_inpaintnet_checkpoint(ckpt)
    jax_vars, jax_params = jax_convert_inpaintnet_checkpoint(ckpt)
    bridged = state_dict_from_flax(jax_vars)
    assert port_params == jax_params == {"seq_len": 12}
    assert set(port_sd) == set(bridged) == set(InpaintNet().state_dict())
    for k in port_sd:
        assert torch.equal(port_sd[k], bridged[k]), k


def _pattern(rng, kind: str, n: int = 40):
    vis = np.ones(n, int)
    if kind == "random":
        vis = rng.integers(0, 2, n)
    elif kind == "head gap":
        vis[:5] = 0
    elif kind == "tail gap":
        vis[-6:] = 0
    elif kind == "interior gaps":
        vis[8:12] = vis[20:21] = vis[30:34] = 0
    elif kind == "none visible":
        vis[:] = 0
    y = rng.integers(0, 120, n)  # across the 0.05 * 719 threshold
    y[vis == 0] = 0
    return {"x": list(rng.integers(0, W, n) * vis), "y": list(y), "visibility": list(vis)}


@pytest.mark.parametrize("kind", ["random", "head gap", "tail gap", "interior gaps",
                                  "none visible", "all visible"])
def test_generate_inpaint_mask_equals_jax(rng, kind):
    for _ in range(5):
        pred = _pattern(rng, kind)
        for th_h in (30, H * 0.05):
            assert generate_inpaint_mask(pred, th_h) == jax_generate_inpaint_mask(pred, th_h)


def _trackers(tmp_path, rng):
    path = tmp_path / "inpaintnet.pt"
    write_checkpoint(rng, path)
    jax_t = JaxBallTracker(None, str(path), compute_dtype=jnp.float32,
                           config=JaxBallConfig(batch_size=4, median_max_sample_num=4))
    port_t = BallTracker(None, str(path), compute_dtype=torch.float32, device="cpu",
                         config=BallTrackerConfig(batch_size=4, median_max_sample_num=4))
    assert port_t.inpaintnet_seq_len == jax_t.inpaintnet_seq_len == 16
    assert port_t.COOR_TH == jax_t.COOR_TH
    jax_t.video_info_post_init(JaxVideoInfo(width=W, height=H, fps=30, total_frames=0))
    port_t.video_info_post_init(VideoInfo(width=W, height=H, fps=30, total_frames=0))
    return jax_t, port_t


def _pred(rng, n: int) -> dict:
    """A ball trajectory in source pixels with a gap at the head and one
    inside, the ball low (y > 0.05 H) on both sides of each: both inpainted."""
    vis = np.ones(n, int)
    vis[:3] = 0
    vis[n // 2: n // 2 + 4] = 0
    t = np.arange(n)
    x = (100 + 13 * t + rng.integers(0, 7, n)) % W
    y = 300 + (t * 7) % 200 + rng.integers(0, 5, n)
    return {"frame": list(range(n)), "x": [int(v) for v in x * vis],
            "y": [int(v) for v in y * vis], "visibility": [int(v) for v in vis]}


def _capture_jax_ensemble(jax_t) -> list:
    """The JAX pass's per-chunk ensembles, recorded from its jitted step."""
    captured = []
    real = jax_t.inpaintnet.jit_step

    def spy(key, build):
        step = real(key, build)

        def recorded(*args):
            out = step(*args)
            captured.append(np.asarray(out[0]))
            return out

        return recorded

    jax_t.inpaintnet.jit_step = spy
    return captured


@pytest.mark.parametrize("n", [10, 16, 80], ids=["shorter", "one window", "over a jax chunk"])
def test_inpaint_pass_equals_jax(tmp_path, rng, n):
    jax_t, port_t = _trackers(tmp_path, rng)
    pred = _pred(rng, n)
    mask = generate_inpaint_mask(pred, th_h=H * 0.05)
    assert mask[0] == 1 and sum(mask) >= 3 + 4  # both gaps inpainted
    captured = _capture_jax_ensemble(jax_t)
    want = jax_t._inpaint_pass(dict(pred), n)
    got = port_t._inpaint_pass(dict(pred), n)
    if n < 16:
        assert got == want == pred and port_t.inpaint_ensemble(pred, n) is None and not captured
        return
    ens_jax = np.concatenate(captured)[:n]
    ens = port_t.inpaint_ensemble(pred, n)
    assert ens.shape == (n, 2) and ens.dtype == np.float32
    assert float(np.abs(ens - ens_jax).max()) <= ENS_TOL
    for axis, (key, size, dim) in enumerate((("x", port_t.WIDTH, W), ("y", port_t.HEIGHT, H))):
        scaler = dim / size
        a = np.array([float(v * size * scaler) for v in ens[:, axis]])
        b = np.array([float(v * size * scaler) for v in ens_jax[:, axis]])
        assert [int(v) for v in a] == got[key] and [int(v) for v in b] == want[key]
        differ = np.array(got[key]) != np.array(want[key])
        near_edge = (np.abs(a - np.round(a)) <= ENS_TOL * dim) & (
            np.abs(b - np.round(b)) <= ENS_TOL * dim)
        assert np.all(near_edge[differ]), (key, a[differ], b[differ])
        assert np.all(np.abs(np.array(got[key]) - np.array(want[key])) <= 1)
    flipped = [f for f in range(n) if (got["x"][f], got["y"][f]) != (want["x"][f], want["y"][f])]
    assert [got["visibility"][f] for f in range(n) if f not in flipped] == [
        want["visibility"][f] for f in range(n) if f not in flipped]
    if n == 80:
        # The interior gap lies in the ensemble's body: its frames now hold a
        # position. (In a one-window clip every frame but the first is the
        # reference's tail, whose coefficients shrink the ensemble towards
        # the clamp.)
        assert all(got["visibility"][f] == 1 for f in range(n // 2, n // 2 + 4))
