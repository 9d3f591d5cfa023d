"""Child processes for the port's multi-rank tests: each runs one rank of a
gloo process group on the CPU and writes its results under a directory the
parent reads. Imports no JAX (a child imports the port only), so the test
modules that compare with the JAX package run the JAX side themselves.

    python tests/_torch_dist.py CASE RANK WORLD PORT OUTDIR [ARGS...]

`spawn` starts the ranks with a free port, one intra-op thread each, and a
time limit; `sharded_clip` and `MaxTrackNet` are the inputs both sides
build, `train_case` the data-parallel train steps' models and batches."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
sys.path[:0] = [str(REPO), str(TESTS)]

from padel_analytics_tpu_torch.parallel import init_distributed, make_mesh  # noqa: E402
from padel_analytics_tpu_torch.parallel import sharded_window_inference  # noqa: E402
from padel_analytics_tpu_torch.trackers._ballwindow import frame_channels  # noqa: E402

#: The sharded window inference's cases: (bg_mode, stride) at seq_len 8 on a
#: clip of SHARD_N frames of SHARD_HW, not a multiple of any world size.
SEQ = 8
SHARD_N, SHARD_HW = 37, (16, 32)
SHARDED_CASES = [(bg, stride) for bg in ("concat", "subtract") for stride in (1, SEQ)]
#: The port's windows a TrackNet call in those cases (smaller than a shard,
#: and not a divisor of it, so the batches and the carry are exercised).
SHARD_BATCH = 4
#: Seconds a rank may take, and its process group's collective timeout.
TIMEOUT_S = 120


def sharded_clip(bg_mode: str, seed: int = 7):
    """(frames (N, H, W, C_f) uint8, median (H, W, 3) uint8): dark noise with
    two bright blobs moving at different speeds, each gone for a while,
    both for some frames."""
    rng = np.random.default_rng(seed)
    h, w = SHARD_HW
    c = frame_channels(bg_mode)
    frames = rng.integers(0, 90, (SHARD_N, h, w, c), dtype=np.uint8)
    for i in range(SHARD_N):
        x0, y0 = (2 + 2 * i) % (w - 4), 3 + i % 9
        if not 14 <= i < 30:
            frames[i, y0: y0 + 3, x0: x0 + 3] = 230
        if not 12 <= i < 27:
            x1 = (w - 5 - i) % (w - 3)
            frames[i, 10:13, x1: x1 + 2] = 200
    median = rng.integers(0, 90, (h, w, 3), dtype=np.uint8)
    return frames, median


class MaxTrackNet(torch.nn.Module):
    """A decisive TrackNet stand-in: window frame c's heatmap is 1 where the
    largest of its channels exceeds 0.5, else 0 (exact on both sides, so
    the ensemble's sums are the same bits)."""

    def __init__(self, bg_mode: str, seq_len: int = SEQ):
        super().__init__()
        self.first = 3 if bg_mode == "concat" else 0
        self.c = frame_channels(bg_mode)
        self.seq_len = seq_len

    def forward(self, x):
        maps = [(x[..., self.first + k * self.c: self.first + (k + 1) * self.c].amax(-1) > 0.5)
                for k in range(self.seq_len)]
        return torch.stack(maps, dim=-1).float()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(case: str, world: int, out: Path, args=()) -> list[Path]:
    """Run `case` on `world` ranks (with the strings `args` after its mesh
    and directory); returns each rank's output directory. Raises with the
    ranks' output when one fails or the time runs out."""
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    dirs = [out / f"rank{r}" for r in range(world)]
    procs = []
    for r, d in enumerate(dirs):
        d.mkdir(parents=True, exist_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__)), case, str(r), str(world), str(port), str(d),
             *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    if bad:
        raise RuntimeError(f"case {case!r}, {world} ranks failed: {bad}")
    return dirs


def _sharded(mesh, out: Path) -> None:
    for bg, stride in SHARDED_CASES:
        frames, median = sharded_clip(bg)
        cx, cy, vis = sharded_window_inference(MaxTrackNet(bg), frames, median, mesh,
                                               seq_len=SEQ, bg_mode=bg, stride=stride,
                                               batch=SHARD_BATCH)
        np.save(out / f"{bg}_{stride}.npy", np.stack([cx, cy, vis]))


def _fused(mesh, out: Path) -> None:
    from _torch_fused_cases import N, caches, clip_frames, make_trackers
    from padel_analytics_tpu_torch.trackers import FusedPipeline

    frames = clip_frames(np.random.default_rng(3))
    pipe = FusedPipeline(*make_trackers(), chunk=4)
    (out / "caches.json").write_text(json.dumps(caches(pipe.run_mesh(iter(frames), N, mesh))))


def _runner(mesh, out: Path) -> None:
    """TrackingRunner(mesh=...) saving its files under out/files; the rank's
    own results and data (written whatever its rank) beside it."""
    from _torch_fused_cases import caches, clip_frames, make_trackers
    from padel_analytics_tpu_torch.trackers import TrackingRunner
    from padel_analytics_tpu_torch.utils.video import MemoryClip

    files = out / "files"
    files.mkdir()
    clip = MemoryClip(clip_frames(np.random.default_rng(3)), fps=10.0)
    trackers = make_trackers(save_dir=files)
    runner = TrackingRunner(list(trackers), clip, files / "out.mp4", fused=True, fused_chunk=4,
                            render=False, collect_data=True, mesh=mesh)
    runner.run()
    runner.write_csv(files / "data.csv")
    results = dict(zip(("players", "players_keypoints", "ball", "keypoints"),
                       (t.results.predictions for t in trackers)))
    (out / "caches.json").write_text(json.dumps(caches(results)))
    runner.data_analytics.write_csv(out / "report.csv", 10.0)


def _fused_runner(mesh, out: Path) -> None:
    """The `fused` and the `runner` cases, into out/fused and out/runner, in
    one process group (one start-up of the ranks for both)."""
    for name, case in (("fused", _fused), ("runner", _runner)):
        (out / name).mkdir()
        case(mesh, out / name)


#: BallTracker(mesh=...)'s cases: (clip length, window stride). 12 frames on
#: two ranks leave a shard shorter than the halo: the single-device path.
BALL_CASES = [(26, 1), (26, SEQ), (12, 1)]


def ball_tracker(n: int, stride: int, mesh=None, device="cpu"):
    """A BallTracker at the fused cases' size with the bright-pixel
    TrackNet."""
    from _torch_fused_cases import W, H, BrightTrackNet
    from padel_analytics_tpu_torch.config import BallTrackerConfig
    from padel_analytics_tpu_torch.trackers import BallTracker
    from padel_analytics_tpu_torch.utils.video import VideoInfo

    ball = BallTracker(None, compute_dtype=torch.float32, device=device, mesh=mesh,
                       config=BallTrackerConfig(height=72, width=128, batch_size=4,
                                                median_max_sample_num=6, window_stride=stride))
    ball.tracknet.model = BrightTrackNet()
    return ball.video_info_post_init(VideoInfo(width=W, height=H, fps=10.0, total_frames=n))


def _ball(mesh, out: Path) -> None:
    from _torch_fused_cases import clip_frames

    for n, stride in BALL_CASES:
        frames = clip_frames(np.random.default_rng(3), n=n)
        balls = ball_tracker(n, stride, mesh).predict_frames(iter(frames), total_frames=n)
        (out / f"ball_{n}_{stride}.json").write_text(json.dumps([b.serialize() for b in balls]))


def _sharded_ball(mesh, out: Path) -> None:
    """The `sharded` and the `ball` cases, into out/sharded and out/ball, in
    one process group."""
    for name, case in (("sharded", _sharded), ("ball", _ball)):
        (out / name).mkdir()
        case(mesh, out / name)


#: The data-parallel train steps' cases: a global batch of TRAIN_BATCH
#: split over the ranks.
TRAIN_BATCH = 4
TRAIN_FAMILIES = ("yolo_det", "yolo_pose", "tracknet", "court_masked", "inpaint")


def train_case(name: str):
    """(a model with seeded LeCun weights, the global batch as numpy arrays,
    the port's train step maker taking the mesh) of one family."""
    from padel_analytics_tpu_torch.models.layers import lecun_normal_
    from padel_analytics_tpu_torch.models.resnet import ResNet50Regressor
    from padel_analytics_tpu_torch.models.tracknet import InpaintNet, make_tracknet
    from padel_analytics_tpu_torch.models.yolov8 import YOLOv8
    from padel_analytics_tpu_torch.training import (
        make_court_train_step,
        make_inpaintnet_train_step,
        make_tracknet_train_step,
        make_yolo_train_step,
    )

    rng = np.random.default_rng(len(name))
    b = TRAIN_BATCH
    if name.startswith("yolo"):
        nk = 3 if name == "yolo_pose" else 0
        model = YOLOv8("n", 1, nk)
        xy = rng.uniform(2, 30, (b, 4, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(14, 32, (b, 4, 2))], -1)
        mask = np.zeros((b, 4), bool)
        mask[:, :2] = True
        mask[1, 2] = True  # the ranks' shards hold different gt counts
        batch = [rng.uniform(0, 1, (b, 64, 64, 3)), np.zeros((b, 4), np.int32), boxes]
        if nk:
            k = xy[:, :, None] + rng.uniform(0, 14, (b, 4, nk, 2))
            batch.append(np.concatenate([k, (rng.uniform(0, 1, (b, 4, nk, 1)) < 0.7) * 2.0], -1))
        batch.append(mask)
        step = lambda mesh: make_yolo_train_step(pose=bool(nk), mesh=mesh)  # noqa: E731
    elif name == "tracknet":
        model, in_dim = make_tracknet(4, "concat")
        c = rng.integers(1, 30, (b, 4, 2)).astype(np.float32)
        from padel_analytics_tpu_torch.training import gaussian_heatmap_labels

        labels = gaussian_heatmap_labels(torch.from_numpy(c), 16, 32).permute(0, 2, 3, 1)
        batch = [rng.uniform(0, 1, (b, 16, 32, in_dim)), labels.numpy()]
        step = make_tracknet_train_step
    elif name == "court_masked":
        model = ResNet50Regressor(6, (1, 1, 1, 1))
        mask = (rng.uniform(0, 1, (b, 3)) < 0.6).astype(np.float32)
        batch = [rng.normal(0, 1, (b, 64, 64, 3)), rng.uniform(0, 1, (b, 6)), mask]
        step = make_court_train_step
    else:
        model = InpaintNet()
        mask = (rng.uniform(0, 1, (b, 16, 1)) < 0.3).astype(np.float32)
        batch = [rng.uniform(0, 1, (b, 16, 2)) * (1 - mask), mask, rng.uniform(0, 1, (b, 16, 2))]
        step = make_inpaintnet_train_step
    lecun_normal_(model, torch.Generator().manual_seed(len(name)))
    batch = [a.astype(np.float32) if a.dtype == np.float64 else a for a in batch]
    return model, batch, step


def train_step_result(name: str, mesh=None, rows: slice = slice(None), device="cpu") -> dict:
    """One Adam step (lr 1e-3) of `name` on `rows` of its global batch, on
    `device`: {'loss', 'grad.<param>', 'param.<param>', 'buffer.<name>'} as
    numpy. With a mesh that has a model axis, the model is sharded over it
    first (`shard_params_for_tp`), and the sharded gradients and
    parameters are gathered after the step; 'sharded' lists the sharded
    weights' names."""
    from padel_analytics_tpu_torch.parallel import gather_params, shard_params_for_tp
    from padel_analytics_tpu_torch.parallel.tensor_parallel import tp_axis
    from padel_analytics_tpu_torch.training import init_train_state

    model, batch, step = train_case(name)
    tp = mesh is not None and mesh.model is not None
    if tp:
        shard_params_for_tp(model, mesh)
    state, loss = step(mesh)(init_train_state(model.to(device), 1e-3), *(
        torch.from_numpy(np.ascontiguousarray(a[rows])).to(device) for a in batch))
    sharded = sorted(f"{k}.weight" for k, m in model.named_modules() if tp_axis(m) is not None)
    out = {"loss": np.asarray(float(loss))}
    for k, p in state.model.named_parameters():
        g = mesh.model.all_gather(p.grad, 0) if k in sharded else p.grad
        out[f"grad.{k}"] = g.cpu().numpy()
    if tp:
        gather_params(model, mesh)
        out["sharded"] = np.asarray(sharded, dtype=str)
    for k, p in state.model.named_parameters():
        out[f"param.{k}"] = p.detach().cpu().numpy()
    for k, v in state.model.named_buffers():
        out[f"buffer.{k}"] = v.cpu().numpy()
    return out


def train_yolo_argv(data: Path, out: Path) -> list[str]:
    """apps.train_yolo's arguments on the dataset under `data`: one epoch of
    one global batch of 4 at 64 x 64."""
    return ["--images", str(data / "images"), "--labels", str(data / "labels"), "--imgsz", "64",
            "--epochs", "1", "--batch", "4", "--max-gt", "4", "--device", "cpu",
            "--out", str(out)]


def _train(mesh, out: Path) -> None:
    """Each family's step on this rank's shard; then apps.train_yolo with
    --data-parallel over the group on the dataset the parent wrote beside
    the ranks' directories (rank 0 writes det.pt)."""
    from padel_analytics_tpu_torch.apps import train_yolo

    per = TRAIN_BATCH // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    for name in TRAIN_FAMILIES:
        np.savez(out / f"{name}.npz", **train_step_result(name, mesh, rows))
    train_yolo.main(train_yolo_argv(out.parent / "data", out / "det.pt")
                    + ["--data-parallel", str(mesh.size)])


def _tp(mesh, out: Path, *families) -> None:
    """Each family's step (all, or those named) on the (data, model) mesh:
    this data rank's shard of the global batch, the model sharded over
    'model'."""
    per = TRAIN_BATCH // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    for name in families or TRAIN_FAMILIES:
        np.savez(out / f"{name}.npz", **train_step_result(name, mesh, rows))


def tp_step_results(world: int, root: Path, families=TRAIN_FAMILIES) -> list[dict]:
    """The 'tp' case on `world` ranks (model 2): each rank's {family: its
    step results}."""
    dirs = spawn("tp", world, root / f"w{world}", families)
    return [{name: dict(np.load(d / f"{name}.npz")) for name in families} for d in dirs]


def tracknet_app_argv(data: Path, out: Path, *extra) -> list[str]:
    """apps.train_tracknet on the rally under `data`: one step, a global
    batch of 8 windows of 4 frames at 32 x 64 (one step: free-running Adam
    steps part within a step, tests/_torch_train.py)."""
    return ["--match-dir", str(data / "match"), "--rallies", "r1", "--epochs", "1", "--batch",
            "8", "--seq-len", "4", "--height", "32", "--width", "64", "--device", "cpu",
            "--out", str(out), *extra]


def inpaint_app_argv(data: Path, out: Path, *extra) -> list[str]:
    return ["--match-dir", str(data / "match"), "--rallies", "r1", "--epochs", "1", "--batch",
            "4", "--seq-len", "8", "--synthetic-gaps", "--img-wh", "160", "90", "--device",
            "cpu", "--out", str(out), *extra]


def court_app_argv(data: Path, out: Path, *extra) -> list[str]:
    return ["--images", str(data / "court"), "--keypoints", str(data / "court.json"),
            "--imgsz", "64", "--batch", "4", "--epochs", "1", "--stage-sizes", "1,1,1,1",
            "--device", "cpu", "--out", str(out), *extra]


def train_step_f64_grads(name: str) -> dict:
    """The one-process step's gradient of `name` in float64 on the CPU (the
    models keep their own fp32 casts): the yardstick of fp32 gradients,
    {'grad.<param>': numpy}."""
    from padel_analytics_tpu_torch.training import init_train_state

    model, batch, step = train_case(name)
    model = model.double()
    b = [torch.from_numpy(a).double() if a.dtype == np.float32 else torch.from_numpy(a)
         for a in batch]
    step(None)(init_train_state(model, 1e-3), *b)
    return {f"grad.{k}": p.grad.numpy() for k, p in model.named_parameters()}


def _tp_cuda(mesh, out: Path) -> None:
    """TrackNet's sharded step with both ranks on the card (data 1 x
    model 2, gloo)."""
    np.savez(out / "tracknet.npz", **train_step_result("tracknet", mesh, device=mesh.device))


def write_app_data(root: Path) -> None:
    """The train apps' datasets under `root`: a 14-frame 160 x 90 rally
    (match/frame/r1, match/csv/r1_ball.csv), 4 YOLO images with one box
    each (images, labels) and 4 court frames with 12 keypoints (court,
    court.json)."""
    import csv

    from PIL import Image

    rng = np.random.default_rng(5)
    fd = root / "match" / "frame" / "r1"
    fd.mkdir(parents=True)
    (root / "match" / "csv").mkdir()
    rows = []
    for i in range(14):
        img = rng.integers(55, 65, (90, 160, 3), dtype=np.uint8)
        x, y, visible = 10 + i * 9, 40 + int(6 * np.sin(i)), i % 5 != 4
        if visible:
            img[y - 2: y + 3, x - 2: x + 3] = (250, 250, 120)
        Image.fromarray(img).save(fd / f"{i}.png")
        rows.append({"Frame": i, "X": x * visible, "Y": y * visible, "Visibility": int(visible)})
    with open(root / "match" / "csv" / "r1_ball.csv", "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=["Frame", "X", "Y", "Visibility"])
        wtr.writeheader()
        wtr.writerows(rows)
    for d in ("images", "labels", "court"):
        (root / d).mkdir()
    kps = {}
    for i in range(4):
        img = rng.integers(20, 50, (64, 64, 3), dtype=np.uint8)
        x0, y0 = 8 + 6 * i, 10 + 4 * i
        img[y0: y0 + 30, x0: x0 + 24] = 220
        Image.fromarray(img).save(root / "images" / f"im{i}.png")
        (root / "labels" / f"im{i}.txt").write_text(
            f"0 {(x0 + 12) / 64} {(y0 + 15) / 64} {24 / 64} {30 / 64}\n")
        Image.fromarray(rng.integers(20, 60, (60, 80, 3), dtype=np.uint8)).save(
            root / "court" / f"f{i}.png")
        kps[f"f{i}.png"] = [[10.0 + 5 * k + i, 50.0 - 3 * k] for k in range(12)]
    (root / "court.json").write_text(json.dumps(kps))


#: The tensor-parallel app runs: (app module name, argv maker, output file).
TP_APPS = [("train_tracknet", tracknet_app_argv, "tracknet.pt"),
           ("train_inpaintnet", inpaint_app_argv, "inpaint.pt"),
           ("train_court", court_app_argv, "court.msgpack"),
           ("train_yolo", train_yolo_argv, "det.pt")]


def _tp_apps(mesh, out: Path) -> None:
    """The four train apps with --model-parallel over the group, on the
    datasets the parent wrote beside the ranks' directories (rank 0 writes
    each file); train_tracknet --resume of its own file with no epoch; then
    TrackingRunner(mesh=...) with the decisive fakes (the `runner` case)."""
    import importlib

    data = out.parent / "data"
    mp = ["--model-parallel", str(mesh.shape["model"])]
    for app, argv, name in TP_APPS:
        importlib.import_module(f"padel_analytics_tpu_torch.apps.{app}").main(
            argv(data, out / name) + mp)
    from padel_analytics_tpu_torch.apps import train_tracknet

    # Every rank reads rank 0's file.
    src = out.parent / "rank0" / "tracknet.pt"
    torch.distributed.barrier()
    train_tracknet.main(tracknet_app_argv(data, out / "resumed.pt", "--resume", str(src),
                                          "--epochs", "0") + mp)
    with torch.inference_mode():
        _runner(mesh, out)


CASES = {"sharded": _sharded, "fused": _fused, "runner": _runner, "ball": _ball,
         "fused_runner": _fused_runner, "sharded_ball": _sharded_ball,
         "train": _train, "tp": _tp, "tp_apps": _tp_apps, "tp_cuda": _tp_cuda}
#: The cases that train: autograd on (the others run under inference_mode).
TRAINING = {"train", "tp", "tp_apps", "tp_cuda"}
#: The cases on a (data, model) mesh: their model axis's size.
MODEL_AXIS = {"tp": 2, "tp_apps": 2, "tp_cuda": 2}
#: The cases whose ranks all sit on the card (gloo: NCCL refuses two ranks
#: on one card).
ON_CARD = {"tp_cuda"}


def main(case: str, rank: int, world: int, port: int, out: str, *args: str) -> None:
    torch.set_num_threads(1)
    device = "cuda:0" if case in ON_CARD else "cpu"
    init_distributed(device, backend="gloo", rank=rank, world_size=world, timeout_s=TIMEOUT_S,
                     init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh(model=MODEL_AXIS.get(case, 1), device=device)
        if case in TRAINING:
            CASES[case](mesh, Path(out), *args)
        else:
            with torch.inference_mode():
                CASES[case](mesh, Path(out), *args)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:])
