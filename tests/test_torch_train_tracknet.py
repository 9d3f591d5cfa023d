"""The port's ball-model training (`training/tracknet.py`,
`training/inpaintnet.py`, `training/augmentation.py::frame_mixup`,
`training/data.py`) against the JAX package's on the same seeded inputs.

- heatmap labels equal; the WBCE within 1e-6 of the JAX loss (relative),
  its gradient within 1e-5 of the largest (optax-free: the same formula,
  torch's and XLA's log);
- frame mixup on the JAX draws (its Beta lamb and its sorted pick, drawn
  from the JAX key as the JAX function draws them): frames, heatmaps,
  coordinates and visibility within 1e-6 of theirs (the JAX side blends in
  float64 under the suite's x64 mode);
- load_rally on a rally written to disk: the same uint8 frames and median,
  the same coordinates; load_inpaint_rally and load_image_bicubic01 the
  same arrays; window_batches (no mixup) and the coordinate
  windows of a synthesized InpaintNet rally: the same batches, exactly;
- one and three Adam steps (lr 1e-3) of TrackNet (concat, 27 channels, 32 x
  64, batch 2) and InpaintNet (seq 16, batch 4) from the same weights
  (state_dict_from_flax) on the same batches as the JAX package's jitted
  steps: losses, gradients, parameters and running statistics within the
  bounds of tests/_torch_train.py (which says why the three steps each
  start from the JAX step's parameters).
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_helpers import random_jax_tracknet
from _torch_train import (
    LR,
    assert_grads,
    assert_losses,
    assert_params,
    assert_stats,
    jax_optimizer,
    port_steps,
    run_jax_steps,
)
from padel_analytics_tpu.models.tracknet import InpaintNet as JaxInpaintNet
from padel_analytics_tpu.training import augmentation as jaug
from padel_analytics_tpu.training import data as jdata
from padel_analytics_tpu.training import inpaintnet as jinp
from padel_analytics_tpu.training import tracknet as jtn
from padel_analytics_tpu_torch.models.convert import state_dict_from_flax
from padel_analytics_tpu_torch.models.tracknet import InpaintNet, make_tracknet
from padel_analytics_tpu_torch.training import augmentation, data
from padel_analytics_tpu_torch.training.inpaintnet import make_inpaintnet_train_step
from padel_analytics_tpu_torch.training.state import init_train_state
from padel_analytics_tpu_torch.training.tracknet import (
    gaussian_heatmap_labels,
    make_tracknet_train_step,
    weighted_bce_loss,
)

HW = (32, 64)
SEQ = 8


def _centers(rng, n, h, w):
    c = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], -1).astype(np.float32)
    c[::4] = 0.0  # absent balls
    return c


def test_heatmap_labels_equal_jax(rng):
    c = _centers(rng, 12, 24, 40).reshape(3, 4, 2)
    for sigma in (2.5, 1.0):
        want = np.asarray(jtn.gaussian_heatmap_labels(jnp.asarray(c), 24, 40, sigma))
        got = gaussian_heatmap_labels(torch.from_numpy(c), 24, 40, sigma).numpy()
        np.testing.assert_array_equal(got, want)


def test_wbce_equals_jax(rng):
    pred = rng.uniform(0, 1, (2, 8, 16, 4)).astype(np.float32)
    pred[0, 0, :4, 0] = [0.0, 1.0, 1e-9, 1 - 1e-9]  # the clip's saturated ends
    target = (rng.uniform(0, 1, pred.shape) < 0.1).astype(np.float32)
    want, g_want = jax.value_and_grad(jtn.weighted_bce_loss)(jnp.asarray(pred),
                                                               jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = weighted_bce_loss(p, torch.from_numpy(target))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))  # relative
    g_want = np.asarray(g_want)
    assert np.abs(p.grad.numpy() - g_want).max() <= 1e-5 * np.abs(g_want).max()


def _mixup_window(rng, l=8, h=12, w=20):
    frames = rng.uniform(0, 255, (l, h, w, 3)).astype(np.float32)
    coords = _centers(rng, l, h, w)
    vis = (coords.sum(-1) > 0).astype(np.float32)
    vis[3] = 0.0  # a run of invisible frames the chained labels carry over
    coords[3] = 0.0
    coords[5] = coords[4] + 1  # a near-static pair (snaps to the current label)
    return frames, coords, vis


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_mixup_on_jax_draws(rng, seed):
    frames, coords, vis = _mixup_window(rng)
    src = coords * 3.0  # source-resolution coordinates (the snap's scale)
    key = jax.random.PRNGKey(seed)
    want = jaug.frame_mixup(key, jnp.asarray(frames), jnp.asarray(coords), jnp.asarray(vis),
                            12, 20, coords_src=jnp.asarray(src))
    # The JAX function's own draws, from its own key split.
    k_lamb, k_pick = jax.random.split(key)
    lamb = float(jax.random.beta(k_lamb, 0.5, 0.5))
    pick = np.sort(np.asarray(jax.random.choice(k_pick, 15, shape=(8,), replace=False)))
    got = augmentation.frame_mixup(None, torch.from_numpy(frames), torch.from_numpy(coords),
                                   torch.from_numpy(vis), 12, 20,
                                   coords_src=torch.from_numpy(src), lamb=lamb, pick=pick)
    for g, w, name in zip(got, want, ("frames", "heat", "coords", "vis")):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-6 * max(np.abs(w).max(), 1.0), name


def _write_rally(root, rid, n=14, h=45, w=80, seed=0):
    """A rally on disk (frames and the ball CSV), invisible every 5th frame."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    fd = root / "frame" / rid
    fd.mkdir(parents=True)
    (root / "csv").mkdir(exist_ok=True)
    rows = []
    for i in range(n):
        img = rng.integers(40, 70, (h, w, 3), dtype=np.uint8)
        x, y = 6 + i * 5, 20 + int(6 * np.sin(i))
        visible = i % 5 != 4
        if visible:
            img[y - 1: y + 2, x - 1: x + 2] = (250, 250, 120)
        Image.fromarray(img).save(fd / f"{i}.png")
        rows.append({"Frame": i, "X": x if visible else 0, "Y": y if visible else 0,
                     "Visibility": int(visible)})
    with open(root / "csv" / f"{rid}_ball.csv", "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=["Frame", "X", "Y", "Visibility"])
        wtr.writeheader()
        wtr.writerows(rows)


def test_load_rally_and_window_batches_equal_jax(tmp_path):
    pytest.importorskip("cv2")  # the JAX package's loader decodes with OpenCV
    _write_rally(tmp_path, "r1")
    want = jdata.load_rally(tmp_path, "r1", height=24, width=40)
    got = data.load_rally(tmp_path, "r1", height=24, width=40)
    for name in ("frames", "median", "coords", "visibility", "coords_src"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)

    jb = list(jdata.window_batches(want, seq_len=4, batch_size=3,
                                   rng=np.random.default_rng(5)))
    tb = list(data.window_batches(got, seq_len=4, batch_size=3, rng=np.random.default_rng(5)))
    assert len(tb) == len(jb) == 3  # 11 windows: a remainder of 2 dropped
    for (x, lab), (xj, labj) in zip(tb, jb):
        np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(labj))
    # with mixup: the shapes, binary-or-blended labels in [0, 1]
    x, lab = next(data.window_batches(got, seq_len=4, batch_size=3, mixup_alpha=0.5,
                                      mixup_rng=np.random.default_rng(1)))
    assert x.shape == (3, 24, 40, 15) and lab.shape == (3, 24, 40, 4)
    assert 0.0 <= float(lab.min()) and float(lab.max()) <= 1.0


def test_inpaint_csv_and_image_loaders_equal_jax(tmp_path):
    """load_inpaint_rally on a predicted_csv (blank cells included, the
    source size from the first frame) and load_image_bicubic01 (PIL bicubic
    squash, Pillow rounding): equal to the JAX package's."""
    pytest.importorskip("cv2")  # the JAX package's loaders decode with OpenCV
    _write_rally(tmp_path, "r1")
    (tmp_path / "predicted_csv").mkdir()
    cols = ["Frame", "X", "Y", "Visibility", "X_GT", "Y_GT", "Visibility_GT", "Inpaint_Mask"]
    rows = [[i, 10 + i if i % 4 else "", 20, int(i % 4 > 0), 11 + i, 21, 1, int(i % 4 == 0)]
            for i in range(14)]
    with open(tmp_path / "predicted_csv" / "r1_ball.csv", "w", newline="") as f:
        csv.writer(f).writerows([cols] + rows[::-1])  # sorted by Frame on load
    want = jdata.load_inpaint_rally(tmp_path, "r1")
    got = data.load_inpaint_rally(tmp_path, "r1")
    assert got.img_wh == want.img_wh == (80, 45)
    for name in ("coords_pred", "coords_gt", "vis_pred", "vis_gt", "inpaint_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    img, wh = data.load_image_bicubic01(tmp_path / "frame" / "r1" / "3.png", (24, 32))
    img_j, wh_j = jdata.load_image_bicubic01(tmp_path / "frame" / "r1" / "3.png", (24, 32))
    assert wh == wh_j == (80, 45)
    np.testing.assert_array_equal(img, img_j)


def test_inpaint_rally_and_coordinate_windows_equal_jax(rng):
    n = 60
    coords = np.stack([np.linspace(40, 600, n), 180 + 120 * np.sin(np.linspace(0, 4, n))],
                      -1).astype(np.float32)
    vis = (rng.uniform(0, 1, n) > 0.1).astype(np.float32)
    want = jdata.synthesize_inpaint_rally(coords, vis, (640, 360), np.random.default_rng(3),
                                          gap_rate=0.2)
    got = data.synthesize_inpaint_rally(coords, vis, (640, 360), np.random.default_rng(3),
                                        gap_rate=0.2)
    for name in ("coords_pred", "coords_gt", "vis_pred", "vis_gt", "inpaint_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.inpaint_mask.sum() > 0
    jb = list(jdata.coordinate_window_batches(want, 16, 4, np.random.default_rng(2), 3))
    tb = list(data.coordinate_window_batches(got, 16, 4, np.random.default_rng(2), 3))
    assert len(tb) == len(jb) == 3
    for t, j in zip(tb, jb):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------------ steps


@pytest.fixture(scope="module")
def tracknet_run():
    """Three JAX TrackNet steps from random weights on three batches."""
    rng = np.random.default_rng(11)
    model, in_dim, variables = random_jax_tracknet(rng, "concat", SEQ, HW)
    batches = []
    for _ in range(3):
        x = rng.uniform(0, 1, (2, *HW, in_dim)).astype(np.float32)
        c = _centers(rng, 2 * SEQ, *HW).reshape(2, SEQ, 2)
        labels = np.moveaxis(np.asarray(jtn.gaussian_heatmap_labels(jnp.asarray(c), *HW)), 1, -1)
        batches.append((x, labels.astype(np.float32)))
    opt = jax_optimizer()
    state = jtn.TrackNetTrainState(variables["params"], variables["batch_stats"],
                                   opt.init(variables["params"]), 0)
    step = jax.jit(jtn.make_tracknet_train_step(model, opt))
    return variables, batches, *run_jax_steps(step, state, [tuple(map(jnp.asarray, b))
                                                            for b in batches])


def _port_tracknet(variables):
    model, _ = make_tracknet(SEQ, "concat")
    model.load_state_dict(state_dict_from_flax(variables))
    return init_train_state(model, LR)


def test_tracknet_one_step_equals_jax(tracknet_run):
    variables, batches, losses, grads, _, _ = tracknet_run
    state = _port_tracknet(variables)
    state, loss = make_tracknet_train_step()(state, *map(torch.from_numpy, batches[0]))
    assert_losses([float(loss)], losses[:1])
    assert_grads(state.model, grads[0])


def test_tracknet_three_steps_equal_jax(tracknet_run):
    variables, batches, losses, _, starts, final = tracknet_run
    state, got = port_steps(_port_tracknet(variables), make_tracknet_train_step(), batches,
                            starts)
    assert_losses(got, losses)
    assert state.step == 3
    assert_params(state.model, final.params)
    assert_stats(state.model, final.params, final.batch_stats)


@pytest.fixture(scope="module")
def inpaint_run():
    rng = np.random.default_rng(12)
    model = JaxInpaintNet()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 2)),
                            jnp.zeros((1, 16, 1)))

    def fill(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map(np.asarray, dict(jax.tree_util.tree_map_with_path(
        fill, shapes))["params"])
    batches = []
    for _ in range(3):
        coords = rng.uniform(0, 1, (4, 16, 2)).astype(np.float32)
        mask = (rng.uniform(0, 1, (4, 16, 1)) < 0.3).astype(np.float32)
        target = np.clip(coords + rng.normal(0, 0.05, coords.shape), 0, 1).astype(np.float32)
        batches.append((coords * (1 - mask), mask, target))
    opt = jax_optimizer()
    state = jtn.TrackNetTrainState(params, {}, opt.init(params), 0)
    step = jax.jit(jinp.make_inpaintnet_train_step(model, opt))
    return params, batches, *run_jax_steps(step, state, [tuple(map(jnp.asarray, b))
                                                         for b in batches])


def test_inpaintnet_steps_equal_jax(inpaint_run):
    params, batches, losses, grads, starts, final = inpaint_run
    model = InpaintNet()
    model.load_state_dict(state_dict_from_flax({"params": params}))
    state = init_train_state(model, LR)
    step = make_inpaintnet_train_step()
    state, loss = step(state, *map(torch.from_numpy, batches[0]))
    assert_losses([float(loss)], losses[:1])
    assert_grads(state.model, grads[0])
    model.load_state_dict(state_dict_from_flax({"params": params}))
    state, got = port_steps(init_train_state(model, LR), step, batches, starts)
    assert_losses(got, losses)
    assert_params(state.model, final.params)


def test_adam_matches_optax_on_a_tensor():
    """torch Adam with optax.adam's defaults takes optax's updates: three
    steps on one tensor within 1e-6 lr (the update formulas differ only in
    rounding)."""
    g = [np.array([0.3, -2.0, 1e-3, 5.0], np.float32) * (i + 1) for i in range(3)]
    opt = optax.adam(LR)
    p = jnp.zeros(4, jnp.float32)
    s = opt.init(p)
    for gi in g:
        u, s = opt.update(jnp.asarray(gi), s, p)
        p = optax.apply_updates(p, u)
    t = torch.zeros(4, requires_grad=True)
    topt = torch.optim.Adam([t], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for gi in g:
        t.grad = torch.from_numpy(gi)
        topt.step()
    assert np.abs(t.detach().numpy() - np.asarray(p)).max() <= 1e-6 * LR
