"""The train apps and the mesh runner on a (data 1 x model 2) mesh of two
gloo ranks (tests/_torch_dist.py, case 'tp_apps'), on the CPU.

- (d) train_tracknet, train_inpaintnet, train_court (.msgpack) and
  train_yolo with --model-parallel 2 write, from global rank 0 alone, what
  the one-process run (--model-parallel 1) writes, within the sharded
  step's bounds (tests/test_torch_tensor_parallel.py): at most 1% of the
  parameters more than 0.05 lr away, the running statistics within 1e-5 of
  their BatchNorm's largest running variance; the gathered file is the
  bytes an unsharded model with its values writes; train_tracknet --resume
  of that file onto the 1 x 2 mesh with no epoch writes it back exactly.
- (e) TrackingRunner(fused=True, mesh=...) with the decisive fakes over
  the 1 x 2 mesh (run_mesh over 'data', replicated over 'model'): global
  rank 0 writes run()'s caches and data.csv byte for byte (run() with the
  association scan, which a mesh run takes); rank 1 writes nothing.
"""

import importlib

import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_fused_cases import clip_frames, make_trackers
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu_torch.models.resnet import ResNet50Regressor
from padel_analytics_tpu_torch.models.tracknet import make_tracknet
from padel_analytics_tpu_torch.training import checkpoint
from padel_analytics_tpu_torch.training.checkpoint import load_for_resume
from padel_analytics_tpu_torch.trackers import TrackingRunner
from padel_analytics_tpu_torch.utils.video import MemoryClip

LR = 1e-3
FAMILY = {"train_tracknet": "tracknet", "train_inpaintnet": "inpaintnet",
          "train_court": "resnet", "train_yolo": "yolo"}


@pytest.fixture(scope="module")
def tp_apps(tmp_path_factory):
    """(the datasets' directory, each rank's output directory)."""
    root = tmp_path_factory.mktemp("tp_apps")
    td.write_app_data(root / "data")
    return root / "data", td.spawn("tp_apps", 2, root)


@pytest.mark.parametrize("app, argv, name", td.TP_APPS, ids=[a[0] for a in td.TP_APPS])
def test_model_parallel_app_equals_one_process(tp_apps, tmp_path, app, argv, name):
    data, dirs = tp_apps
    assert (dirs[0] / name).exists() and not (dirs[1] / name).exists()
    one = tmp_path / name
    assert importlib.import_module(f"padel_analytics_tpu_torch.apps.{app}").main(
        argv(data, one) + ["--model-parallel", "1"]) == 0
    got, want = (load_for_resume(FAMILY[app], p) for p in (dirs[0] / name, one))
    assert got.keys() == want.keys()
    weights = [k for k in want if want[k].is_floating_point() and "running" not in k]
    d = torch.cat([((got[k] - want[k]).abs() / LR).reshape(-1) for k in weights])
    assert float((d > 0.05).float().mean()) <= 1e-2
    for k in want:
        if ".running_" in k:
            scale = float(want[k.rsplit(".", 1)[0] + ".running_var"].abs().max())
            assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("name, save", [
    ("tracknet.pt", lambda p, m: checkpoint.save_tracknet(p, m, 4, "concat")),
    ("court.msgpack", checkpoint.save_resnet)], ids=["pt", "msgpack"])
def test_gathered_file_is_the_unsharded_bytes(tp_apps, tmp_path, name, save):
    _, dirs = tp_apps
    src = dirs[0] / name
    if name.endswith(".pt"):
        model = make_tracknet(4, "concat")[0]
        model.load_state_dict(load_for_resume("tracknet", src))
    else:
        model = ResNet50Regressor(24, (1, 1, 1, 1))
        model.load_state_dict(load_for_resume("resnet", src))
    save(tmp_path / name, model)
    assert (tmp_path / name).read_bytes() == src.read_bytes()


def test_resume_onto_the_mesh_round_trips(tp_apps):
    _, dirs = tp_apps
    assert not (dirs[1] / "resumed.pt").exists()
    got = load_for_resume("tracknet", dirs[0] / "resumed.pt")
    want = load_for_resume("tracknet", dirs[0] / "tracknet.pt")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_runner_on_the_model_axis_writes_run_files_once(tp_apps, tmp_path):
    _, dirs = tp_apps
    files = tmp_path / "files"
    files.mkdir()
    runner = TrackingRunner(list(make_trackers(save_dir=files)),
                            MemoryClip(clip_frames(np.random.default_rng(3)), fps=10.0),
                            files / "out.mp4", fused=True, fused_chunk=4, render=False,
                            collect_data=True, fused_association="device")
    with torch.inference_mode():
        runner.run()
    runner.write_csv(files / "data.csv")
    want = {p.name: p.read_bytes() for p in files.iterdir()}
    got = {p.name: p.read_bytes() for p in (dirs[0] / "files").iterdir()}
    assert sorted(got) == ["ball.json", "court.json", "data.csv", "players.json", "pose.json"]
    assert got == want
    assert not any((dirs[1] / "files").iterdir())
    assert (dirs[1] / "report.csv").read_bytes() == want["data.csv"]
