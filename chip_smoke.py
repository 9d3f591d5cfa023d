"""Drive the PyTorch/CUDA port's ball-tracking path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero and no result line
is printed):

1. report the card (nvidia-smi name and power limit) and the toolchain;
2. build kernels K1 (conv3x3_bn_act) and K2 (heatmap_cc) from csrc/, one
   nvcc each, started together;
3. K1 at the 11 distinct conv shapes of TrackNet at 288x512, batch 8 (relu),
   and at YOLOv8m's 6 stride-1 3x3 shapes at a 640 input, batch 8 (silu),
   against the fp32 plain version; each timed beside its plain version, the
   library call for the same function (cuDNN bf16 conv + affine + act) and
   its bound (the larger of bytes over 3.35 TB/s and FLOPs over 989
   TFLOP/s). The TrackNet shapes are summed over its 17 convs;
4. K2 on batch-8 288x512 heatmaps at both cluster sizes (8 and 16): fuzzed
   blobs (empty map and exact ties included), uniform masks at 10, 50 and
   100% and bars through every band, each bit-equal to the plain version
   and timed; cudaOccupancyMaxActiveClusters of each size and the plan's
   choice printed;
5. the slice: BallTracker at its full configuration (288x512, seq_len 8,
   bg_mode concat, batch 8, bf16, median over the clip's head) with random
   weights from a seed, on a synthetic 1920x1080 rally clip, through
   predict_and_update + save_predictions (the per-tracker body of
   TrackingRunner.run). Every kernel launch counter is zeroed just before
   and read just after; both kernels must have run. A second pass must
   equal the first; a third, under torch.profiler, gives the device busy
   share and each kernel's device time.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
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
# YOLOv8m at a 640 input: (Cin, Cout, H, W) of its distinct stride-1 3x3
# ConvBN shapes (timed, not part of the TrackNet sum).
YOLO_CONVS = [
    (48, 48, 160, 160), (96, 96, 80, 80), (192, 192, 40, 40), (288, 288, 20, 20),
    (192, 64, 80, 80), (576, 192, 20, 20),
]
BATCH = 8
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM3 rate.
PEAK_BF16_FLOPS, PEAK_BYTES_S = 989e12, 3.35e12
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


def graph_time_ms(fn, reps: int = 20) -> float:
    """Mean device time per call of `fn`: `reps` calls captured in one CUDA
    graph after a warm-up, the graph replayed between two events. Replaying
    takes the host's launch cost out of the time of small kernels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
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
    names = ("conv3x3_bn_act", "heatmap_cc")
    _build.build(*names)
    for name in names:
        _build.library(name)
        log = _build.build_log[name]
        print(f"build {name}: {log['seconds']:.2f} s")
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")


def _library_bf16(x, w_oihw, scale, bias, act):
    """One PyTorch call per op for the same function, natively in bf16: cuDNN
    conv on the channels-last view, affine, activation. Timed, never used by
    the port."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1)
    y = y * scale[:, None, None] + bias[:, None, None]
    y = torch.relu(y) if act == "relu" else F.silu(y)
    return y.permute(0, 2, 3, 1)


def k1_bound_ms(cin, cout, h, w, batch=BATCH) -> tuple[float, float]:
    """(operations ms, bytes ms) of one conv on the card: 2 * M * N * K FLOPs
    over the bf16 tensor-core rate; x, w, scale, bias read once and out
    written once (bf16, fp32 affine) over the memory rate. The bound is the
    larger of the two."""
    m = batch * h * w
    nbytes = 2 * m * cin + 2 * 9 * cin * cout + 8 * cout + 2 * m * cout
    flops = 2 * m * cout * 9 * cin
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3


def _k1_shape(dev, g, cin, cout, h, w, act) -> dict:
    x = torch.randn((BATCH, h, w, cin), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((3, 3, cin, cout), generator=g) / math.sqrt(9 * cin)).to(dev)
    scale = (torch.rand(cout, generator=g) + 0.5).to(dev)
    bias = (torch.randn(cout, generator=g) * 0.1).to(dev)
    wk = conv3x3.pack_weight(wt)
    got = conv3x3.conv3x3_bn_act_packed(x, wk, scale, bias, act)
    ref = conv3x3.conv3x3_bn_act_plain(x.float(), wt.to(torch.bfloat16).float(), scale, bias, act)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs()
    ok = bool(torch.all(err <= K1_RTOL * ref.abs() + K1_ATOL))
    max_err = float(err.max())
    del ref, err, got
    check(ok, f"K1 {cin}->{cout} @{h}x{w} {act} beyond its bf16 bound (max err {max_err})")
    w_oihw = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    kernel_ms = graph_time_ms(lambda: conv3x3.conv3x3_bn_act_packed(x, wk, scale, bias, act))
    library_ms = graph_time_ms(lambda: _library_bf16(x, w_oihw, scale, bias, act))
    plain_ms = graph_time_ms(lambda: conv3x3.conv3x3_bn_act_plain(x, wt, scale, bias, act), reps=3)
    ops_ms, bytes_ms = k1_bound_ms(cin, cout, h, w)
    bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    tflop = 2 * BATCH * h * w * cout * 9 * cin / 1e9
    print(f"K1 {cin:>3}->{cout:<3} @{h}x{w} B={BATCH} {act}: kernel {kernel_ms:.3f} ms "
          f"({tflop / kernel_ms:.1f} TFLOP/s, {100 * bound_ms / kernel_ms:.1f}% of its "
          f"{bound_ms:.4f} ms {bound_by} bound), cuDNN bf16 {library_ms:.3f} ms "
          f"({tflop / library_ms:.1f} TFLOP/s), plain fp32 {plain_ms:.3f} ms, "
          f"max abs err {max_err:.3g}")
    return {"ms": kernel_ms, "library_ms": library_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "ops_ms": ops_ms, "max_err": max_err}


def phase_k1(dev) -> dict:
    g = torch.Generator(device="cpu").manual_seed(1)
    per_shape = {s: _k1_shape(dev, g, *s, "relu")
                 for s in sorted(set(TRACKNET_CONVS), key=TRACKNET_CONVS.index)}
    yolo = {s: _k1_shape(dev, g, *s, "silu") for s in YOLO_CONVS}
    tot = {k: sum(per_shape[s][k] for s in TRACKNET_CONVS)
           for k in ("ms", "library_ms", "plain_ms", "bound_ms", "ops_ms")}
    # The sum is bound by operations where they take most of the bound.
    bound_by = "operations" if tot.pop("ops_ms") >= tot["bound_ms"] / 2 else "bytes"
    print(f"K1 over TrackNet's 17 convs at B={BATCH}: kernel {tot['ms']:.3f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f}% of the {tot['bound_ms']:.3f} ms bound), "
          f"cuDNN bf16 {tot['library_ms']:.3f} ms, plain fp32 {tot['plain_ms']:.3f} ms")
    print(f"K1 over YOLOv8m's 6 shapes (once each) at B={BATCH}: kernel "
          f"{sum(v['ms'] for v in yolo.values()):.3f} ms, cuDNN bf16 "
          f"{sum(v['library_ms'] for v in yolo.values()):.3f} ms")
    return {"name": "conv3x3_bn_act", "route": "cuda",
            "source": "padel_analytics_tpu_torch/csrc/conv3x3_bn_act.cu",
            "replaces": "padel_analytics_tpu/ops/pallas_conv.py:211, "
                        "padel_analytics_tpu/ops/pallas_conv.py:322",
            "max_abs_err": max(v["max_err"] for v in [*per_shape.values(), *yolo.values()]),
            **tot, "bound_by": bound_by}


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


def _bars(rng, n, h, w) -> np.ndarray:
    """Vertical bars through every band (far longer than num_iters), one per
    map at a random column, beside a small blob."""
    hms = np.zeros((n, h, w), np.float32)
    for i in range(n):
        c = rng.integers(2, w - 8)
        hms[i, 1:h - 1, c:c + 3] = 1.0
        hms[i, 100:104, (c + 100) % (w - 4):(c + 100) % (w - 4) + 4] = 1.0
    return hms


def _k2_case(name, hms, plans) -> dict:
    """K2 on `hms` at each cluster size of `plans`: bit-equal to the plain
    version, then timed as device time (CUDA-graph replay) and per call
    (a launch loop, the host's cost included)."""
    want = heatmap.decode_heatmaps_plain(hms)
    ms, loop_ms = {}, {}
    for c, plan in plans.items():
        got = heatmap._decode_cuda(hms, 0.5, 32, plan)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"K2 {name} at cluster {c} not bit-equal: {a} vs {b}")
        ms[c] = graph_time_ms(lambda: heatmap._decode_cuda(hms, 0.5, 32, plan))
        loop_ms[c] = cuda_time_ms(lambda: heatmap._decode_cuda(hms, 0.5, 32, plan), reps=20)
    mask = float((hms > 0.5).float().mean())
    print(f"K2 {name} B={hms.shape[0]} {hms.shape[1]}x{hms.shape[2]} (mask {100 * mask:.1f}%): "
          + ", ".join(f"cluster {c} {ms[c]:.4f} ms ({loop_ms[c]:.4f} a call in a launch loop)"
                      for c in plans) + "; bit-equal")
    return ms


def phase_k2(dev) -> dict:
    h, w = 288, 512
    lib = _build.library("heatmap_cc")
    plans = {c: heatmap.cc_plan(h, w, c) for c in heatmap.CLUSTER_SIZES}
    chosen = heatmap.cc_plan(h, w).cluster
    for c, plan in plans.items():
        n = ctypes.c_int(-1)
        _build.check(lib.heatmap_cc_max_active_clusters(c, plan.smem_bytes, ctypes.byref(n)),
                     "heatmap_cc_max_active_clusters")
        print(f"K2 cluster {c}: {plan.rows_per_block} rows a block, {plan.threads} threads, "
              f"{plan.smem_bytes} B dynamic shared memory, {sum(plan.bits[:2]) * 2 + plan.bits[2]} "
              f"bits a pixel; cudaOccupancyMaxActiveClusters {n.value}")
    print(f"K2 plan's cluster size at {h}x{w}: {chosen}")

    rng = np.random.default_rng(2)
    hms = torch.from_numpy(_heatmaps(rng, BATCH, h, w)).to(dev)
    got = heatmap.decode_heatmaps(hms)
    torch.cuda.synchronize()
    check(int(got[2][-2]) == 0, "K2 empty heatmap must be invisible")
    blobs = _k2_case("blobs (empty map and tie included)", hms, plans)
    plain_ms = cuda_time_ms(lambda: heatmap.decode_heatmaps_plain(hms), reps=3)
    dense = {d: _k2_case(f"uniform mask {d:.0%}",
                         torch.from_numpy((rng.random((BATCH, h, w)) < d).astype(np.float32)).to(dev),
                         plans)
             for d in (0.1, 0.5, 1.0)}
    _k2_case("band-crossing bars", torch.from_numpy(_bars(rng, BATCH, h, w)).to(dev), plans)
    print(f"K2 B={BATCH} {h}x{w} at the plan's cluster {chosen}: blobs {blobs[chosen]:.4f} ms, "
          f"dense 50% {dense[0.5][chosen]:.4f} ms; plain (blobs) {plain_ms:.3f} ms")
    # Bound: the fp32 heatmaps read once and three int32 results written once;
    # its few integer operations per pixel are far below the byte time.
    bound_ms = (hms.numel() * 4 + 3 * BATCH * 4) / PEAK_BYTES_S * 1e3
    return {"name": "heatmap_cc", "route": "cuda",
            "source": "padel_analytics_tpu_torch/csrc/heatmap_cc.cu",
            "replaces": "padel_analytics_tpu/ops/pallas_cc.py:108",
            "max_abs_err": 0, "ms": blobs[chosen], "dense_ms": dense[0.5][chosen],
            "cluster": chosen, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


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


def phase_slice() -> dict:
    n = 64
    frames = synthetic_rally(n, seed=6)
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "ball.json"
        # No device argument: the entry point's default is the card.
        tracker = BallTracker(None, config=BallTrackerConfig(), save_path=save,
                              compute_dtype=torch.bfloat16, seed=0)
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
    profile_pass(tracker, frames)
    return launches


def profile_pass(tracker, frames) -> None:
    """A third pass under torch.profiler: device busy time (kernels and
    copies, one stream) against the pass's wall time, and each kernel's
    device time. Measured, not checked: the profiler's own cost slows the
    host side of this pass."""
    from torch.profiler import ProfilerActivity, profile

    tracker.restart()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tracker.predict_and_update(iter(frames), total_frames=len(frames))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("slice profile: device time not measured (the profiler saw no device activity)")
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    parts = []
    for name, key in (("K1", "conv3x3_bn_act"), ("K2", "heatmap_cc")):
        ev = [e for e in dev if key in e.name]
        parts.append(f"{name} {sum(e.time_range.elapsed_us() for e in ev) / 1e3:.3f} ms "
                     f"in {len(ev)} launches")
    print(f"slice profile: pass {wall_ms:.1f} ms under the profiler, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); " + "; ".join(parts))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    dev = torch.device("cuda", 0)
    smi = phase_report()
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    phase_model(dev)
    launches = phase_slice()
    k1["launches"] = launches["conv3x3_bn_act"]
    k2["launches"] = launches["heatmap_cc"]
    print(smi)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
