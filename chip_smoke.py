"""Drive the PyTorch/CUDA port's ball-tracking path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero and no result line
is printed):

1. report the card (nvidia-smi name and power limit) and the toolchain;
2. build kernels K1 (conv3x3_bn_act) and K2 (heatmap_cc) from csrc/;
3. K1 at the 11 distinct conv shapes of TrackNet at 288x512, batch 8,
   against the fp32 plain version, and timed against the plain PyTorch op
   in bf16 (cuDNN conv + affine + act);
4. K2 on batch-8 288x512 fuzzed heatmaps (empty map and exact ties
   included), bit-equal to the plain version, both timed;
5. the slice: BallTracker at its full configuration (288x512, seq_len 8,
   bg_mode concat, batch 8, bf16, median over the clip's head) with random
   weights from a seed, on a synthetic 1920x1080 rally clip, through
   predict_and_update + save_predictions (the per-tracker body of
   TrackingRunner.run). Every kernel launch counter is zeroed just before
   and read just after; both kernels must have run.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from padel_analytics_tpu_torch import _build
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.models.tracknet import make_tracknet
from padel_analytics_tpu_torch.models.layers import lecun_normal_
from padel_analytics_tpu_torch.ops import conv3x3, heatmap
from padel_analytics_tpu_torch.trackers import BallTracker
from padel_analytics_tpu_torch.utils.video import VideoInfo

# TrackNet at 288x512: (Cin, Cout, H, W) of its 17 stride-1 3x3 ConvBNs, in
# call order; 11 distinct shapes.
TRACKNET_CONVS = [
    (27, 64, 288, 512), (64, 64, 288, 512),
    (64, 128, 144, 256), (128, 128, 144, 256),
    (128, 256, 72, 128), (256, 256, 72, 128), (256, 256, 72, 128),
    (256, 512, 36, 64), (512, 512, 36, 64), (512, 512, 36, 64),
    (768, 256, 72, 128), (256, 256, 72, 128), (256, 256, 72, 128),
    (384, 128, 144, 256), (128, 128, 144, 256),
    (192, 64, 288, 512), (64, 64, 288, 512),
]
BATCH = 8
# K1 bound: kernel and reference round (nearly) the same fp32 sum to bf16,
# so |kernel - ref| <= 2 bf16 ulp (2 * 2^-7 relative) + 1e-3 absolute for
# sums that cancel to ~0.
K1_RTOL, K1_ATOL = 2.0 ** -6, 1e-3
# Whole-model check: the bf16 K1 path against the fp32 plain path, sigmoid
# heatmaps after 18 convs in bf16.
MODEL_ATOL = 5e-2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_time_ms(fn, reps: int = 10) -> float:
    """Mean device time per call over `reps` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_report() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton_version} "
          f"nvcc: {nvcc}")
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    for name in ("conv3x3_bn_act", "heatmap_cc"):
        _build.library(name)
        log = _build.build_log[name]
        print(f"build {name}: {log['seconds']:.2f} s")
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")


def _cudnn_bf16(x, w_oihw, scale, bias):
    """Timed baseline: the plain PyTorch op natively in bf16 (cuDNN conv on
    the channels-last view, affine, ReLU)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1)
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    return y.permute(0, 2, 3, 1)


def phase_k1(dev) -> dict:
    g = torch.Generator(device="cpu").manual_seed(1)
    per_shape = {}
    for cin, cout, h, w in sorted(set(TRACKNET_CONVS), key=TRACKNET_CONVS.index):
        x = torch.randn((BATCH, h, w, cin), generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((3, 3, cin, cout), generator=g) / math.sqrt(9 * cin)).to(dev)
        scale = (torch.rand(cout, generator=g) + 0.5).to(dev)
        bias = (torch.randn(cout, generator=g) * 0.1).to(dev)
        wk = conv3x3.pack_weight(wt)
        got = conv3x3.conv3x3_bn_act_packed(x, wk, scale, bias, "relu")
        ref = conv3x3.conv3x3_bn_act_plain(x.float(), wt.to(torch.bfloat16).float(),
                                           scale, bias, "relu")
        torch.cuda.synchronize()
        err = (got.float() - ref).abs()
        ok = bool(torch.all(err <= K1_RTOL * ref.abs() + K1_ATOL))
        max_err = float(err.max())
        del ref, err
        check(ok, f"K1 {cin}->{cout} @{h}x{w} beyond its bf16 bound (max err {max_err})")
        w_oihw = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        kernel_ms = cuda_time_ms(lambda: conv3x3.conv3x3_bn_act_packed(x, wk, scale, bias, "relu"))
        plain_ms = cuda_time_ms(lambda: _cudnn_bf16(x, w_oihw, scale, bias))
        gflop = 2 * BATCH * h * w * cout * 9 * cin / 1e9
        per_shape[(cin, cout, h, w)] = (kernel_ms, plain_ms, max_err)
        print(f"K1 {cin:>3}->{cout:<3} @{h}x{w} B={BATCH}: kernel {kernel_ms:.3f} ms "
              f"({gflop / kernel_ms:.1f} TFLOP/s), plain bf16 {plain_ms:.3f} ms "
              f"({gflop / plain_ms:.1f} TFLOP/s), max abs err {max_err:.3g}")
        del x, wt, wk, got
    ms = sum(per_shape[s][0] for s in TRACKNET_CONVS)
    plain = sum(per_shape[s][1] for s in TRACKNET_CONVS)
    print(f"K1 over TrackNet's 17 convs at B={BATCH}: kernel {ms:.3f} ms, plain bf16 {plain:.3f} ms")
    return {"name": "conv3x3_bn_act", "route": "cuda",
            "source": "padel_analytics_tpu_torch/csrc/conv3x3_bn_act.cu",
            "replaces": "padel_analytics_tpu/ops/pallas_conv.py:211",
            "max_abs_err": max(v[2] for v in per_shape.values()), "ms": ms, "plain_ms": plain}


def _heatmaps(rng, n, h, w) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w]
    hms = []
    for _ in range(n - 2):
        hm = np.zeros((h, w))
        for _ in range(rng.integers(1, 4)):
            cy, cx, s = rng.integers(5, h - 5), rng.integers(5, w - 5), rng.uniform(1.5, 5.0)
            hm += np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
        hms.append(hm)
    hms.append(np.zeros((h, w)))  # empty
    tie = np.zeros((h, w))
    tie[40:45, 100:105] = 1.0
    tie[200:205, 300:305] = 1.0  # equal areas
    hms.append(tie)
    return np.stack(hms).astype(np.float32)


def phase_k2(dev) -> dict:
    hms = torch.from_numpy(_heatmaps(np.random.default_rng(2), BATCH, 288, 512)).to(dev)
    got = heatmap.decode_heatmaps(hms)
    want = heatmap.decode_heatmaps_plain(hms)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        check(torch.equal(a, b), f"K2 not bit-equal to its plain version: {a} vs {b}")
    check(int(got[2][-2]) == 0, "K2 empty heatmap must be invisible")
    kernel_ms = cuda_time_ms(lambda: heatmap.decode_heatmaps(hms))
    plain_ms = cuda_time_ms(lambda: heatmap.decode_heatmaps_plain(hms), reps=3)
    dense = torch.rand((BATCH, 288, 512), generator=torch.Generator().manual_seed(3)).to(dev)
    dense_ok = all(torch.equal(a, b) for a, b in zip(heatmap.decode_heatmaps(dense),
                                                     heatmap.decode_heatmaps_plain(dense)))
    check(dense_ok, "K2 not bit-equal on a dense (random) mask")
    dense_ms = cuda_time_ms(lambda: heatmap.decode_heatmaps(dense), reps=3)
    print(f"K2 B={BATCH} 288x512 blobs: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"dense ~50% mask: kernel {dense_ms:.3f} ms; bit-equal")
    return {"name": "heatmap_cc", "route": "cuda",
            "source": "padel_analytics_tpu_torch/csrc/heatmap_cc.cu",
            "replaces": "padel_analytics_tpu/ops/pallas_cc.py:108",
            "max_abs_err": 0, "ms": kernel_ms, "plain_ms": plain_ms}


def phase_model(dev) -> None:
    """TrackNet on the card (bf16, K1) against its fp32 plain path."""
    model, in_dim = make_tracknet(8, "concat")
    lecun_normal_(model, torch.Generator().manual_seed(4))
    model.eval()
    x = torch.rand((2, 64, 128, in_dim), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        ref = model(x)
    model.to(dev)
    with torch.inference_mode():
        got = model(x.to(dev, torch.bfloat16)).cpu()
    check(got.shape == ref.shape == (2, 64, 128, 8), "TrackNet output shape")
    check(bool(torch.isfinite(got).all()), "TrackNet output not finite")
    err = float((got - ref).abs().max())
    check(err <= MODEL_ATOL, f"TrackNet bf16 on the card vs fp32 plain: max err {err}")
    print(f"TrackNet 2x64x128 bf16 (K1) vs fp32 plain: max abs err {err:.4f} "
          f"(bound {MODEL_ATOL})")


def synthetic_rally(n: int, seed: int) -> list[np.ndarray]:
    """A 1920x1080 RGB clip: a blue court with white lines, sensor noise and a
    bright ball on a parabolic path."""
    rng = np.random.default_rng(seed)
    h, w = 1080, 1920
    court = np.empty((h, w, 3), np.uint8)
    court[:] = (40, 90, 160)
    court[:, 300:310] = court[:, 1610:1620] = 255
    court[150:160, 300:1620] = court[900:910, 300:1620] = court[525:530, 300:1620] = 255
    frames = []
    ys, xs = np.mgrid[-8:9, -8:9]
    disk = ys**2 + xs**2 <= 64
    for i in range(n):
        f = court + rng.integers(0, 12, (h, w, 3), dtype=np.uint8)
        cx = 200 + 24 * i
        cy = int(900 - 30 * i + 0.45 * i * i)
        patch = f[cy - 8: cy + 9, cx - 8: cx + 9]
        patch[disk] = (235, 240, 80)
        frames.append(f)
    return frames


def phase_slice(dev) -> dict:
    n = 64
    frames = synthetic_rally(n, seed=6)
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "ball.json"
        tracker = BallTracker(None, config=BallTrackerConfig(), save_path=save,
                              compute_dtype=torch.bfloat16, device=dev, seed=0)
        tracker.video_info_post_init(VideoInfo(width=1920, height=1080, fps=30.0, total_frames=n))

        conv3x3.reset_launches()
        heatmap.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tracker.predict_and_update(iter(frames), total_frames=n)
        tracker.save_predictions()
        first_s = time.perf_counter() - t0
        launches = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(save.exists() and len(json.loads(save.read_text())) == n, "saved JSON cache")

    balls = list(tracker.results)
    chunks = -(-(n + 7) // 8)
    check(len(balls) == n and [b.frame for b in balls] == list(range(n)), "one Ball per frame")
    check(all(b.visibility in (0, 1) and all(math.isfinite(v) for v in b.xy) for b in balls),
          "ball fields")
    check(all(0 <= b.xy[0] < 1920 and 0 <= b.xy[1] < 1080 for b in balls), "ball in frame")
    check(launches["conv3x3_bn_act"] == 17 * chunks,
          f"K1 launches {launches['conv3x3_bn_act']} != 17 x {chunks} chunks")
    check(launches["heatmap_cc"] >= chunks, f"K2 launches {launches['heatmap_cc']} < {chunks}")

    # Second pass on the same tracker: steady-state speed and determinism.
    first = [b.serialize() for b in balls]
    tracker.restart()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracker.predict_and_update(iter(frames), total_frames=n)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    check([b.serialize() for b in tracker.results] == first, "second pass differs")
    print(f"slice: {n} frames 1920x1080, {chunks} chunks, visible {sum(b.visibility for b in balls)}; "
          f"first pass {n / first_s:.1f} frames/s, second pass {n / second_s:.1f} frames/s; "
          f"peak device memory {peak_gib:.2f} GiB; launches {launches}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    dev = torch.device("cuda", 0)
    smi = phase_report()
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    phase_model(dev)
    launches = phase_slice(dev)
    k1["launches"] = launches["conv3x3_bn_act"]
    k2["launches"] = launches["heatmap_cc"]
    print(smi)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
