"""Data-parallel training over the port's Mesh: a gloo group of 2 CPU
ranks (tests/_torch_dist.py) takes one Adam step on a global batch of 4,
each rank its shard of 2, and gives the single-process step on the whole
batch: YOLOv8n detect and pose (the target-score sum `tss` and the kobj
count global), TrackNet (BatchNorm statistics all-reduced), the masked
ResNet court (its weight sum global, BatchNorm) and InpaintNet (its
weight sum global).

Bounds: the loss within 1e-5 (relative); the running statistics within
1e-5 of their BatchNorm's largest running variance; the gradients within 1e-3 (relative L2,
whole model) and the parameters after the step with at most 1% of the
elements more than 0.05 lr away (the two sides sum in other orders, and
Adam's first step turns a rounding-noise gradient into +-lr; see
tests/_torch_train.py). Both ranks end with the same parameters, exactly.
A per-shard statistic or normalizer misses the loss by far more (a
shard's BatchNorm statistics or `tss` are not the batch's).

Also: apps.train_yolo --data-parallel 2 on two ranks writes the
single-process app's checkpoint, and a gloo group of one rank in this
process takes the no-mesh step bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist as td
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu_torch.parallel import init_distributed, make_mesh
from padel_analytics_tpu_torch.training.checkpoint import load_for_resume

LR = 1e-3


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank child run: each rank's step results, and its directory
    (apps.train_yolo's checkpoint, on the dataset under `root / 'data'`)."""
    root = tmp_path_factory.mktemp("train2")
    _yolo_dataset(root / "data")
    dirs = td.spawn("train", 2, root)
    results = [{name: dict(np.load(d / f"{name}.npz")) for name in td.TRAIN_FAMILIES}
               for d in dirs]
    return root, dirs, results


def _stats_close(got: dict, want: dict) -> None:
    """Every running mean and variance within 1e-5 of the largest running
    variance of its BatchNorm (a mean near 0 is a sum that cancels: its
    error scales with the spread, not with itself)."""
    for k in want:
        if ".running_" in k:
            scale = float(np.abs(np.asarray(want[k.rsplit(".", 1)[0] + ".running_var"])).max())
            err = float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
            assert err <= 1e-5 * scale, f"{k}: {err} at scale {scale}"


def _rel_l2(got: dict, want: dict, prefix: str) -> float:
    keys = [k for k in want if k.startswith(prefix)]
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    return (num / sum(float(np.sum(want[k] ** 2)) for k in keys)) ** 0.5


@pytest.mark.parametrize("name", td.TRAIN_FAMILIES)
def test_two_rank_step_equals_single_process(two_ranks, name):
    want = td.train_step_result(name)
    r0, r1 = (r[name] for r in two_ranks[2])
    for k in r0:
        if k.startswith(("param.", "buffer.")) or k == "loss":
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)  # the ranks agree exactly
    assert abs(float(r0["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    _stats_close({k[len("buffer."):]: v for k, v in r0.items() if k.startswith("buffer.")},
                 {k[len("buffer."):]: v for k, v in want.items() if k.startswith("buffer.")})
    assert _rel_l2(r0, want, "grad.") <= 1e-3
    d = np.concatenate([np.abs(r0[k] - want[k]).reshape(-1) / LR for k in want
                        if k.startswith("param.")])
    assert float(np.mean(d > 0.05)) <= 1e-2


def _yolo_dataset(root):
    from PIL import Image

    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(4)
    for i in range(4):
        img = rng.integers(20, 50, (64, 64, 3), dtype=np.uint8)
        x0, y0 = 8 + 6 * i, 10 + 4 * i
        img[y0: y0 + 30, x0: x0 + 24] = 220
        Image.fromarray(img).save(root / "images" / f"im{i}.png")
        cx, cy = (x0 + 12) / 64, (y0 + 15) / 64
        (root / "labels" / f"im{i}.txt").write_text(f"0 {cx} {cy} {24 / 64} {30 / 64}\n")


def test_train_yolo_app_data_parallel_equals_one_process(two_ranks, tmp_path):
    from padel_analytics_tpu_torch.apps import train_yolo

    root, dirs, _ = two_ranks
    assert (dirs[0] / "det.pt").exists() and not (dirs[1] / "det.pt").exists()
    one = tmp_path / "one.pt"
    train_yolo.main(td.train_yolo_argv(root / "data", one))
    got, want = load_for_resume("yolo", dirs[0] / "det.pt"), load_for_resume("yolo", one)
    assert got.keys() == want.keys()
    weights = [k for k in want if want[k].is_floating_point() and "running" not in k]
    d = torch.cat([((got[k] - want[k]).abs() / LR).reshape(-1) for k in weights])
    assert float((d > 0.05).float().mean()) <= 1e-2  # as the step above
    _stats_close(got, want)


@pytest.fixture()
def one_rank_group():
    init_distributed("cpu", rank=0, world_size=1, timeout_s=60,
                     init_method=f"tcp://127.0.0.1:{td.free_port()}")
    try:
        yield make_mesh(data=1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["yolo_det", "tracknet"])
def test_one_rank_mesh_step_is_the_plain_step(one_rank_group, name):
    got = td.train_step_result(name, one_rank_group)
    want = td.train_step_result(name)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
