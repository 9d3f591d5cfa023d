"""Kernels K1 and K2 on the card against their plain PyTorch versions,
YOLOv8m, ResNet-50, the subpixel TrackNet, the banded resize and the NMS on
the card against their CPU results, and the fused pipeline on the card
against the per-tracker paths and its CPU run (decisive fakes), the fast
configuration ('derived' ingest, nonoverlap ball stride), the model court
and InpaintNet included; the multi-device path (an NCCL group of one rank:
the sharded window inference, run_mesh, BallTracker(mesh=...)) and the
association scan on the card against their single-device and CPU results;
the train steps on the card against the CPU and through the mesh, and
apps/evaluate through K1.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. They import
neither JAX nor the test suite's conftest, so on the card they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist as td
from _k2_cases import SMALL, dense, small
from _torch_fused_cases import (
    BLANK,
    H,
    N,
    W,
    BrightTrackNet,
    CellDetector,
    caches,
    clip_frames,
    court_clip,
    make_trackers,
    model_court,
    per_tracker,
)
from padel_analytics_tpu_torch import _build
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.models.layers import lecun_normal_
from padel_analytics_tpu_torch.models.resnet import ResNet50Regressor, imagenet_normalize
from padel_analytics_tpu_torch.models.tracknet import InpaintNet
from padel_analytics_tpu_torch.models.yolov8 import YOLOv8
from padel_analytics_tpu_torch.ops import conv3x3, heatmap, nms
from padel_analytics_tpu_torch.trackers import BallTracker, FusedPipeline
from padel_analytics_tpu_torch.utils.video import VideoInfo

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1/K2 have no CPU mode)")
    return torch.device("cuda", 0)


def _bf16_close(got, want):
    """K1 bound: the kernel and the plain version round the same fp32 sum
    (taken in another order) to bf16, so they differ by at most 2 bf16 ulp
    (2 * 2^-7 relative) plus an absolute 1e-2 for sums that cancel to ~0
    (inputs are O(1), K up to 4608 terms)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = 2.0 ** -6 * want.abs() + 1e-2
    assert torch.all(err <= bound), f"max err {err.max().item()} beyond bound"


@pytest.mark.parametrize(
    "b,h,w,cin,cout,act",
    [
        (2, 36, 64, 27, 64, "relu"),    # TrackNet stem: Cin padded 27 -> 32
        (1, 20, 30, 64, 128, "silu"),   # M not a multiple of the 128-row tile
        (1, 9, 16, 256, 72, "none"),    # Cout not a multiple of the 64 tile
        (2, 12, 8, 8, 8, "relu"),       # 8 channels: one k-block, 56 of its 64 zero-filled
        (2, 20, 20, 48, 48, "silu"),    # YOLOv8m 20x20 width: 32-wide tiles, Cout 48
        (1, 40, 40, 576, 192, "silu"),  # W = 40 (16-wide tiles), 9 k-blocks, Cout 192
        (3, 7, 40, 192, 256, "relu"),   # H = 7 overhangs the tile rows; Cout 256 (bn 128)
        (1, 5, 20, 27, 48, "none"),     # the padded stem width with a ragged W = 20
        (2, 11, 20, 96, 64, "none"),    # B*H*W = 440, no multiple of 128
        (2, 6, 128, 128, 128, "relu"),  # TrackNet-like 64-wide tiles, exact fit
        (2, 5, 256, 64, 64, "relu"),    # 2 x 128 tiles (pixels on N), H = 5 overhangs
        (1, 4, 128, 27, 48, "silu"),    # pixels on N with the stem width, Cout 48
        # YOLOv8m at the players path's 384x640 letterbox and the pose
        # path's 1280x1280 squash:
        (2, 12, 20, 288, 288, "silu"),  # P5 of detect: 12x20, Cout 288
        (2, 12, 20, 576, 64, "silu"),   # box head at 12x20
        (2, 24, 40, 192, 192, "silu"),  # P4 of detect: 24x40
        (1, 24, 40, 384, 64, "silu"),   # box head at 24x40
        (1, 96, 160, 48, 48, "silu"),   # P2 of detect: Cout 48 at width 160
        (1, 40, 320, 48, 48, "silu"),   # P2 of pose: Cout 48 at width 320
        (1, 40, 40, 576, 48, "silu"),   # pose keypoint head 576 -> 48
        (1, 80, 80, 384, 48, "silu"),   # pose keypoint head 384 -> 48
        (1, 48, 80, 192, 64, "silu"),   # box head at 48x80
        # TrackNet's subpixel skip convs (identity epilogue) and YOLOv8m-pose
        # at 640x640:
        (1, 72, 128, 256, 256, "none"),
        (1, 144, 256, 128, 128, "none"),
        (2, 288, 512, 64, 64, "none"),
        (2, 160, 160, 48, 48, "silu"),  # P2 of pose @640
        (1, 20, 20, 576, 48, "silu"),   # keypoint head at 20x20
        # The court YOLOv8m-pose's keypoint head (12 keypoints, c4 = 48) at
        # 640 and ResNet-50's stride-1 conv2s at 224 (one 16x8 tile covers
        # the 7x7 map):
        (2, 80, 80, 192, 48, "silu"),
        (2, 40, 40, 48, 48, "silu"),
        (2, 56, 56, 64, 64, "relu"),
        (2, 28, 28, 128, 128, "relu"),
        (2, 14, 14, 256, 256, "relu"),
        (3, 7, 7, 512, 512, "relu"),
    ],
)
def test_k1_matches_plain(dev, b, h, w, cin, cout, act):
    g = np.random.default_rng(cin * 1000 + cout)
    x = torch.tensor(g.standard_normal((b, h, w, cin)), dtype=torch.bfloat16, device=dev)
    wt = torch.tensor(g.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin),
                      dtype=torch.float32, device=dev)
    scale = torch.tensor(g.uniform(0.5, 1.5, cout), dtype=torch.float32, device=dev)
    bias = torch.tensor(g.standard_normal(cout) * 0.1, dtype=torch.float32, device=dev)
    before = conv3x3.launches
    got = conv3x3.conv3x3_bn_act(x, wt, scale, bias, act)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    want = conv3x3.conv3x3_bn_act_plain(x, wt, scale, bias, act)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _bf16_close(got, want)


def test_k1_takes_a_channel_slice(dev):
    """C2f hands K1 the halves of a channel split (non-contiguous views);
    the wrapper copies them."""
    g = np.random.default_rng(5)
    y = torch.tensor(g.standard_normal((2, 24, 40, 384)), dtype=torch.bfloat16, device=dev)
    x = y[..., 192:]
    assert not x.is_contiguous()
    wt = torch.tensor(g.standard_normal((3, 3, 192, 192)) / np.sqrt(9 * 192),
                      dtype=torch.float32, device=dev)
    scale = torch.ones(192, device=dev)
    bias = torch.zeros(192, device=dev)
    _bf16_close(conv3x3.conv3x3_bn_act(x, wt, scale, bias, "silu"),
                conv3x3.conv3x3_bn_act_plain(x.contiguous(), wt, scale, bias, "silu"))


# YOLOv8m in bf16 on the card against its fp32 plain path on the CPU, He-normal
# random weights: sigmoid scores (abs) and box coordinates in input pixels
# (abs) after ~90 bf16 layers (chip_smoke.py's bounds; measured <= 2e-4 and
# <= 0.0074 px there).
YOLO_SCORE_ATOL, YOLO_PIXEL_ATOL = 4e-3, 0.5
# The subpixel TrackNet's sigmoid heatmaps (abs; chip_smoke.py's bound,
# measured 0.0065 on the H100) and the floor of their fp32 std (He-normal
# weights give 0.326).
SUBPIXEL_ATOL, SUBPIXEL_MIN_STD = 2e-2, 0.1


def _he_normal(model, seed):
    """N(0, 2/fan_in) conv weights: under LeCun the signal dies out with depth."""
    lecun_normal_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(np.sqrt(2.0))
    return model.eval()


def test_yolov8m_detect_bf16_matches_fp32(dev):
    model = _he_normal(YOLOv8("m", 1), 3)
    x = torch.rand((2, 96, 160, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = model(x)
        model.to(dev)
        before = conv3x3.launches
        got = {k: v.cpu() for k, v in model(x.to(dev, torch.bfloat16)).items()}
    assert conv3x3.launches == before + 52
    assert float((got["scores"] - want["scores"]).abs().max()) <= YOLO_SCORE_ATOL
    assert float((got["boxes"] - want["boxes"]).abs().max()) <= YOLO_PIXEL_ATOL
    assert float(want["scores"].std()) > 0  # the scores depend on the input


@pytest.mark.parametrize("scores", ["tied", "bf16"])
def test_batched_nms_on_card_equals_cpu(dev, scores):
    """The device half (stable top-k, gather, IoU > threshold) on the card
    gives the CPU's slots exactly, ties included."""
    g = np.random.default_rng(9)
    b, a = 8, 2000
    cx, cy = g.uniform(20, 600, (2, b, a))
    w, h = g.uniform(8, 160, (2, b, a))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    if scores == "tied":
        s = np.array([0.1, 0.55, 0.6, 0.75], np.float32)[g.integers(0, 4, (b, a))]
    else:
        s = torch.sigmoid(torch.tensor(g.normal(0, 1.5, (b, a)), dtype=torch.bfloat16).float())
        s = s.numpy()
    kw = dict(conf_thres=0.5, iou_thres=0.7, max_det=32, top_k=128)
    want = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(s), **kw)
    got = nms.batched_nms(torch.from_numpy(boxes).to(dev), torch.from_numpy(s).to(dev), **kw)
    for gt, wt in zip(got, want):
        assert gt.device.type == "cpu" and torch.equal(gt, wt)


def test_k1_rejects_fp32(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev)
    w = torch.zeros((3, 3, 8, 8), device=dev)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_bn_act(x, w, torch.ones(8, device=dev), torch.zeros(8, device=dev))


def _blob(h, w, cy, cx, sigma):
    ys, xs = np.mgrid[0:h, 0:w]
    return np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))


@pytest.mark.parametrize("num_iters", [16, 32])
def test_k2_bit_equal_to_plain(dev, num_iters):
    g = np.random.default_rng(num_iters)
    h, w = 72, 128
    hms = []
    for i in range(12):
        hm = np.zeros((h, w))
        for _ in range(g.integers(0, 4)):
            hm += _blob(h, w, g.integers(5, h - 5), g.integers(5, w - 5), g.uniform(1.0, 4.0))
        hms.append(hm)
    hms.append(np.zeros((h, w)))                           # empty
    tie = np.zeros((h, w))
    tie[10:13, 20:23] = 1.0
    tie[40:43, 90:93] = 1.0                                # equal areas
    hms.append(tie)
    wide = np.zeros((h, w))
    wide[30:33, 2:120] = 1.0                               # wider than num_iters
    wide[50:52, 10:14] = 1.0
    hms.append(wide)
    hms.append(g.uniform(0.0, 1.0, (h, w)))                # dense random mask
    x = torch.tensor(np.stack(hms), dtype=torch.float32, device=dev)
    before = heatmap.launches
    got = heatmap.decode_heatmaps(x, num_iters=num_iters)
    torch.cuda.synchronize()
    assert heatmap.launches == before + 1
    want = heatmap.decode_heatmaps_plain(x.cpu(), num_iters=num_iters)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert torch.equal(a.cpu(), b)


def _k2_bit_equal(x, num_iters, cluster):
    plan = heatmap.cc_plan(*x.shape[1:], cluster)
    assert plan.cluster == cluster
    before = heatmap.launches
    got = heatmap._decode_cuda(x, 0.5, num_iters, plan)
    torch.cuda.synchronize()
    assert heatmap.launches == before + 1
    want = heatmap.decode_heatmaps_plain(x.cpu(), num_iters=num_iters)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("num_iters", [0, 16, 32])
@pytest.mark.parametrize("case", SMALL, ids=lambda f: f.__name__)
def test_k2_band_split_bit_equal(dev, case, num_iters, cluster):
    """Components across band edges and wider than num_iters, cross-band
    ties, ragged and short heatmaps (empty bands), B = 1."""
    _k2_bit_equal(torch.tensor(small(case), device=dev), num_iters, cluster)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("num_iters", [16, 32])
@pytest.mark.parametrize("density", [0.1, 0.5, 1.0])
def test_k2_dense_batch_bit_equal(dev, density, num_iters, cluster):
    """A batch of 8 288x512 uniform random masks."""
    x = torch.tensor(dense(np.random.default_rng(11), density), device=dev)
    _k2_bit_equal(x, num_iters, cluster)


def test_k2_refuses_heatmaps_beyond_its_band_limit(dev):
    before = heatmap.launches
    with pytest.raises(ValueError, match="pixels a block"):
        heatmap.decode_heatmaps(torch.zeros((1, 577, 512), device=dev))
    assert heatmap.launches == before


def test_build_reuses_library(dev):
    conv3x3.conv3x3_bn_act(
        torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16, device=dev),
        torch.zeros((3, 3, 8, 8), device=dev), torch.ones(8, device=dev),
        torch.zeros(8, device=dev),
    )
    assert _build.library("conv3x3_bn_act") is _build.library("conv3x3_bn_act")


@pytest.mark.parametrize("chunk", [4, 8])
def test_fused_on_card_equals_per_tracker(dev, chunk):
    """The fused pipeline's three streams, pinned staging and in-flight
    chunks on the card give the per-tracker paths' caches byte for byte
    (decisive fakes: a race between streams would show as a difference);
    K2 decodes each chunk's ensemble."""
    frames = clip_frames(np.random.default_rng(21))
    want = per_tracker(*make_trackers(device=dev)[:3], frames)
    before = heatmap.launches
    out = FusedPipeline(*make_trackers(device=dev), chunk=chunk).run(iter(frames), N)
    assert heatmap.launches - before == -(-(N + 7) // chunk)
    got = caches(out)
    for key in want:
        assert got[key] == want[key], key


def test_fused_i420_on_card_equals_cpu(dev):
    """The i420 ingest: numpy packing, pinned upload, device decode."""
    frames = clip_frames(np.random.default_rng(22))
    want = caches(FusedPipeline(*make_trackers(), chunk=8, ingest="i420").run(iter(frames), N))
    got = caches(FusedPipeline(*make_trackers(device=dev), chunk=8, ingest="i420")
                 .run(iter(frames), N))
    assert got == want


def test_subpixel_tracknet_on_card_matches_cpu_fp32(dev):
    """TrackNet with subpixel_up in bf16 on the card (K1 on its 14 ConvBNs
    and 3 skip convs, the phase layout, the fp32 epilogue) against the fp32
    plain path of itself and of the dense TrackNet on the CPU, with He-normal
    weights so the heatmaps depend on the input (chip_smoke.py's bound)."""
    from padel_analytics_tpu_torch.models.tracknet import make_tracknet

    model, in_dim = make_tracknet(8, "concat", subpixel_up=True)
    _he_normal(model, 4)
    dense, _ = make_tracknet(8, "concat")
    dense.load_state_dict(model.state_dict())
    dense.eval()
    x = torch.rand((2, 64, 128, in_dim), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        ref, ref_dense = model(x), dense(x)
    assert float(ref.std()) > SUBPIXEL_MIN_STD  # a live signal, not saturated
    model.to(dev)
    before = conv3x3.launches
    with torch.inference_mode():
        got = model(x.to(dev, torch.bfloat16)).cpu()
    assert conv3x3.launches - before == 17
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= SUBPIXEL_ATOL
    assert float((got - ref_dense).abs().max()) <= SUBPIXEL_ATOL


def test_banded_resize_on_card_matches_cpu(dev):
    """The pose squash from 1080p (both passes banded) on the card against
    the CPU: uint8 equal, or one step at a .5 boundary on at most 0.1%."""
    from padel_analytics_tpu_torch.ops import resize

    plan = resize.resize_plan((1080, 1920), (1280, 1280), "pil_bicubic")
    assert plan.forms() == ("banded", "banded")
    img = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 1080, 1920, 3),
                                                             dtype=np.uint8))
    want = torch.floor(plan.apply(img) + 0.5).clamp(0, 255)
    got = torch.floor(plan.apply(img.to(dev)) + 0.5).clamp(0, 255).cpu()
    off = (got - want).abs()
    assert float(off.max()) <= 1.0 and int((off > 0).sum()) <= off.numel() // 1000


@pytest.mark.parametrize("kwargs", [{"ingest": "derived", "wire_long_side": 64},
                                    {"ingest": "derived", "wire_long_side": 64,
                                     "ball_stride": 8}],
                         ids=["derived", "derived-stride8"])
def test_fused_fast_on_card_equals_cpu(dev, kwargs):
    """The fast configuration's ingest and ball mode on the card: the host's
    INTER_AREA and I420 pack, the pinned upload, the nonoverlap windows."""
    frames = clip_frames(np.random.default_rng(23))
    want = caches(FusedPipeline(*make_trackers(), chunk=8, **kwargs).run(iter(frames), N))
    got = caches(FusedPipeline(*make_trackers(device=dev), chunk=8, **kwargs)
                 .run(iter(frames), N))
    assert got == want


# ResNet-50 logits, bf16 on the card against fp32 on the CPU, over their
# largest magnitude (chip_smoke.py's bound; measured 0.0060 on the H100).
RESNET_REL_ATOL = 5e-2


def test_resnet50_bf16_matches_fp32(dev):
    model = _he_normal(ResNet50Regressor(), 17)
    x = imagenet_normalize(torch.rand((2, 224, 224, 3), generator=torch.Generator().manual_seed(18)))
    with torch.inference_mode():
        want = model(x)
    model.to(dev)
    before = conv3x3.launches
    with torch.inference_mode():
        got = model(x.to(dev, torch.bfloat16)).cpu()
    assert conv3x3.launches - before == 13
    assert got.shape == want.shape == (2, 24) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= RESNET_REL_ATOL * float(want.abs().max())


def _inpaint_ball(device, path):
    ball = BallTracker(None, str(path), compute_dtype=torch.float32, device=device,
                       config=BallTrackerConfig(height=72, width=128, batch_size=4,
                                                median_max_sample_num=6))
    ball.tracknet.model = BrightTrackNet()
    return ball.video_info_post_init(VideoInfo(width=W, height=H, fps=10.0, total_frames=N))


def _court_trackers(device, mode, path):
    players, pose, _, _ = make_trackers(device=device, court=False)
    # K1 takes bf16: the ResNet court runs in the trackers' default dtype.
    court = model_court(mode, device=device, compute_dtype=torch.bfloat16)
    if mode == "yolo":
        court.engine.model = CellDetector(pose=True, nk=12)
    else:
        _he_normal(court.engine.model, 24)
        with torch.no_grad():
            court.engine.model.fc.weight.mul_(1e-3)  # logits O(1): live sigmoids
    return players, pose, _inpaint_ball(device, path), court


@pytest.mark.parametrize("mode", ["yolo", "resnet"])
def test_fused_model_court_and_inpaint_on_card(dev, tmp_path, mode):
    """The fused pipeline's fourth lane (the model court) and the inpaint
    pass at its end on the card: the court and the inpainted ball equal the
    per-tracker paths on the card (the yolo court byte for byte with the
    decisive fake; the resnet court within 1e-2 px at the same batch) and
    the yolo run equals the CPU's (a race between five streams would show)."""
    torch.save({"model": lecun_normal_(InpaintNet(), torch.Generator().manual_seed(3))
                .state_dict(), "param_dict": {"seq_len": 16}}, tmp_path / "inpaint.pt")
    frames = court_clip(np.random.default_rng(24))
    players, pose, ball, court = _court_trackers(dev, mode, tmp_path / "inpaint.pt")
    sep_ball = ball.predict_frames(iter(frames), total_frames=N)
    if mode == "yolo":
        sep_court = [k for lo in range(0, N, 4)
                     for k in court.predict_sample(np.stack(frames[lo: lo + 4]))]
    else:
        sep_court = court.predict_frames(iter(frames))
    out = FusedPipeline(*_court_trackers(dev, mode, tmp_path / "inpaint.pt"), chunk=4).run(
        iter(frames), N)
    assert caches({"b": out["ball"]}) == caches({"b": sep_ball})
    if mode == "yolo":
        assert caches({"k": out["keypoints"]}) == caches({"k": sep_court})
        assert [f for f, k in enumerate(out["keypoints"]) if not k] == list(BLANK)
        cpu = FusedPipeline(*_court_trackers("cpu", mode, tmp_path / "inpaint.pt"), chunk=4).run(
            iter(frames), N)
        assert caches(cpu) == caches(out)
    else:
        err = max(abs(p - q) for ka, kb in zip(out["keypoints"], sep_court)
                  for pa, pb in zip(ka, kb) for p, q in zip(pa.xy, pb.xy))
        assert err <= 1e-2


@pytest.fixture()
def nccl_mesh(dev):
    """The mesh as the card's machine runs it: an NCCL group of one rank on
    the card, destroyed after the test."""
    from padel_analytics_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed("cuda", rank=0, world_size=1, timeout_s=120,
                     init_method=f"tcp://127.0.0.1:{td.free_port()}")
    try:
        yield make_mesh(data=1, device=dev)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("bg_mode,stride", td.SHARDED_CASES)
def test_sharded_inference_on_card_equals_cpu(nccl_mesh, bg_mode, stride):
    """One rank on the card (K2 decodes) against the same pass on the CPU:
    the ints bit-equal."""
    from padel_analytics_tpu_torch.parallel import sharded_window_inference

    frames, median = td.sharded_clip(bg_mode)
    net = td.MaxTrackNet(bg_mode)
    before = heatmap.launches
    got = sharded_window_inference(net, frames, median, nccl_mesh, bg_mode=bg_mode, stride=stride,
                                   batch=td.SHARD_BATCH)
    assert heatmap.launches > before
    # The same rank on the CPU, over a gloo group beside the NCCL one.
    cpu = nccl_mesh._replace(group=dist.new_group(backend="gloo"), device=torch.device("cpu"))
    want = sharded_window_inference(net, frames, median, cpu, bg_mode=bg_mode, stride=stride,
                                    batch=td.SHARD_BATCH)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_run_mesh_on_card_equals_run(nccl_mesh):
    """run_mesh on an NCCL group of one rank (the scan under 'auto') gives
    run()'s caches with association='device' byte for byte, and K1/K2 run."""
    frames = clip_frames(np.random.default_rng(25))
    want = caches(FusedPipeline(*make_trackers(device=nccl_mesh.device), chunk=4,
                                association="device").run(iter(frames), N))
    before = heatmap.launches
    got = caches(FusedPipeline(*make_trackers(device=nccl_mesh.device), chunk=4)
                 .run_mesh(iter(frames), N, nccl_mesh))
    assert heatmap.launches > before
    assert got == want


def test_ball_tracker_mesh_on_card_equals_single_device(nccl_mesh):
    for n, stride in td.BALL_CASES:
        frames = clip_frames(np.random.default_rng(3), n=n)
        want = td.ball_tracker(n, stride).predict_frames(iter(frames), total_frames=n)
        got = td.ball_tracker(n, stride, nccl_mesh, nccl_mesh.device).predict_frames(
            iter(frames), total_frames=n)
        assert caches({"b": got}) == caches({"b": want}), (n, stride)


def _crowd(seed, n_frames=40, d=10):
    """Crowded linear tracks with noise, dropouts and low scores (the JAX
    package's test scene, without JAX)."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(80, 1080, d), rng.uniform(80, 520, d)], -1)
    vel, size = rng.uniform(-6, 6, (d, 2)), rng.uniform(40, 90, (d, 2))
    c = pos + vel * np.arange(n_frames)[:, None, None] + rng.normal(0, 1.5, (n_frames, d, 2))
    boxes = np.concatenate([c, c + size], -1).astype(np.float32)
    scores = rng.choice([0.05, 0.18, 0.25, 0.35, 0.7, 0.9], (n_frames, d)).astype(np.float32)
    return boxes, scores, rng.random((n_frames, d)) > 0.06


@pytest.mark.parametrize("seed", [0, 1])
def test_association_scan_on_card_equals_cpu(dev, seed):
    from padel_analytics_tpu_torch.ops import associate_clip

    boxes, scores, valid = _crowd(seed)
    want, want_state = associate_clip(*map(torch.from_numpy, (boxes, scores, valid)))
    got, state = associate_clip(*(torch.from_numpy(a).to(dev) for a in (boxes, scores, valid)))
    assert torch.equal(got.cpu(), want)
    for a, b in zip(state, want_state):
        assert torch.equal(a.cpu(), b)


def _grad_rel_l2(got: dict, want: dict) -> float:
    keys = [k for k in want if k.startswith("grad.")]
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    return (num / sum(float(np.sum(want[k] ** 2)) for k in keys)) ** 0.5


@pytest.mark.parametrize("name", ["tracknet", "court_masked", "inpaint"])
def test_train_step_on_card_equals_cpu(dev, name):
    """One Adam step of the small families (tests/_torch_dist.py) on the card
    against the same step on the CPU, fp32 with TF32 off: the loss within
    1e-4 (relative), the gradient within 2e-2 (relative L2; an fp32 step of
    a random-weight network is ill-conditioned, tests/_torch_train.py).
    YOLO's assignment can tie within rounding on such small random models:
    chip_smoke.py phase 17 holds its card step against the CPU's on fixed
    targets."""
    got = td.train_step_result(name, device=dev)
    want = td.train_step_result(name)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4 * abs(float(want["loss"]))
    assert _grad_rel_l2(got, want) <= 2e-2


def test_train_step_through_nccl_mesh_equals_plain(nccl_mesh):
    """The mesh path on the card (an NCCL group of one rank: the BatchNorm
    statistics, normalizers, gradients and loss all-reduced) against the
    no-mesh step: the loss within 1e-5, the gradient within 1e-3 (cuDNN's
    backward sums in a nondeterministic order)."""
    got = td.train_step_result("yolo_det", nccl_mesh, device=nccl_mesh.device)
    want = td.train_step_result("yolo_det", device=nccl_mesh.device)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    assert _grad_rel_l2(got, want) <= 1e-3


def test_evaluate_on_card_runs_k1(dev, tmp_path, capsys):
    """apps.evaluate on the card: YOLOv8 in eval mode through K1, its one
    JSON line."""
    import json

    from PIL import Image

    from padel_analytics_tpu_torch.apps import evaluate
    from padel_analytics_tpu_torch.training.checkpoint import save_yolov8

    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    rng = np.random.default_rng(5)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            tmp_path / "images" / f"im{i}.png")
        (tmp_path / "labels" / f"im{i}.txt").write_text("0 0.5 0.5 0.4 0.6\n")
    model = lecun_normal_(YOLOv8("n", 1), torch.Generator().manual_seed(0))
    save_yolov8(tmp_path / "det.pt", model)
    before = conv3x3.launches
    assert evaluate.main(["--images", str(tmp_path / "images"), "--labels",
                          str(tmp_path / "labels"), "--weights", str(tmp_path / "det.pt"),
                          "--imgsz", "64", "--conf", "0.0"]) == 0
    assert conv3x3.launches > before
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["images"] == 3


def test_msgpack_tracknet_on_card_equals_pt(dev, tmp_path):
    """A TrackNet written as the JAX package's .msgpack serves through K1
    and K2 on the card exactly as the same weights from the reference's .pt:
    the same weights, the same balls, both kernels launched."""
    from padel_analytics_tpu_torch.models.tracknet import make_tracknet
    from padel_analytics_tpu_torch.training.checkpoint import save_tracknet

    model = _he_normal(make_tracknet(8, "concat")[0], 3)
    save_tracknet(tmp_path / "tn.pt", model, 8, "concat")
    save_tracknet(tmp_path / "tn.msgpack", model, 8, "concat")
    frames = clip_frames(np.random.default_rng(2))
    cfg = BallTrackerConfig(height=72, width=128, batch_size=4, median_max_sample_num=6)
    balls, launches = [], []
    for path in ("tn.pt", "tn.msgpack"):
        tracker = BallTracker(str(tmp_path / path), config=cfg, device=dev)
        tracker.video_info_post_init(VideoInfo(width=W, height=H, fps=10.0, total_frames=N))
        k1, k2 = conv3x3.launches, heatmap.launches
        with torch.inference_mode():
            balls.append([b.serialize() for b in tracker.predict_frames(iter(frames), N)])
        launches.append((conv3x3.launches - k1, heatmap.launches - k2))
    assert balls[0] == balls[1]
    assert launches[0] == launches[1] and all(n > 0 for n in launches[0]), launches
