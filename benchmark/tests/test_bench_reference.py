"""The frozen plain reference against the port's own code at tiny sizes:
the models on one state dict, the preprocessing and the post-processing.
(The test may import both; the reference imports nothing of the port.)"""

import numpy as np
import pytest
import torch

from benchmark.reference import models, postprocess, preprocess
from benchmark.weights import seeded_state_dict
from padel_analytics_tpu_torch.models import tracknet as port_tracknet
from padel_analytics_tpu_torch.models import yolov8 as port_yolo
from padel_analytics_tpu_torch.ops import color, ensemble, heatmap, median, nms, resize


def _pair(ref, port, seed=0):
    gen = torch.Generator().manual_seed(seed)
    sd = seeded_state_dict(ref, gen, "cpu")
    ref.load_state_dict(sd)
    port.load_state_dict(sd)
    return ref.eval(), port.eval()


@pytest.mark.parametrize("nc,nk", [(80, 0), (1, 13), (1, 12)])
def test_yolov8m_matches_the_port(nc, nk):
    ref, port = _pair(models.YOLOv8("m", nc, nk), port_yolo.YOLOv8("m", nc, nk))
    x = torch.rand((2, 64, 96, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = ref(x), port(x)
    for k in ("boxes", "scores") + (("kpts",) if nk else ()):
        torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-3)


def test_tracknet_and_inpaintnet_match_the_port():
    ref, port = _pair(models.TrackNet(27, 8), port_tracknet.TrackNet(27, 8))
    x = torch.rand((2, 16, 32, 27), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(ref(x), port(x), rtol=1e-4, atol=1e-5)
    ref, port = _pair(models.InpaintNet(), port_tracknet.InpaintNet())
    c = torch.rand((3, 16, 2))
    m = (torch.rand((3, 16, 1)) > 0.5).float()
    with torch.no_grad():
        torch.testing.assert_close(ref(c, m), port(c, m), rtol=1e-5, atol=1e-6)


def test_i420_round_trip_is_the_ports():
    rgb = np.random.default_rng(3).integers(0, 256, (2, 6, 10, 3), dtype=np.uint8)
    want = np.stack([color.i420_to_rgb(torch.from_numpy(color.rgb_to_i420(f)), 6,
                                       torch.uint8).numpy() for f in rgb])
    assert np.array_equal(preprocess.i420_round_trip(torch.from_numpy(rgb)).numpy(), want)


@pytest.mark.parametrize("src,dst", [(1080, 1280), (1920, 1280), (1080, 288), (720, 640)])
def test_resize_matrices_are_the_ports(src, dst):
    for name in ("bicubic", "bilinear"):
        assert np.array_equal(preprocess.pil_matrix(src, dst, name),
                              resize.pil_resample_matrix(src, dst, name))
    assert np.array_equal(preprocess.cv2_linear_matrix(src, dst),
                          resize.cv2_bilinear_matrix(src, dst))


def test_letterbox_and_squash_apply_as_the_port():
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 90, 160, 3))).float()
    lb = preprocess.Letterbox((90, 160), 64, "cpu")
    plan = resize.letterbox_plan((90, 160), 64)
    torch.testing.assert_close(lb(x), plan.apply(x), rtol=0, atol=1e-3)
    sq = preprocess.Resize((90, 160), (64, 64), "pil_bicubic", "cpu")
    torch.testing.assert_close(sq(x), resize.resize_plan((90, 160), (64, 64), "pil_bicubic")
                               .apply(x), rtol=0, atol=1e-3)


def test_decode_ensemble_median_and_nms_are_the_ports():
    g = torch.Generator().manual_seed(5)
    heat = torch.rand((6, 24, 40), generator=g) ** 4 * 1.2
    heat[0] = 0
    a = postprocess.decode_heatmaps(heat)
    b = heatmap.decode_heatmaps_plain(heat)
    for u, v in zip(a, b):
        assert u.tolist() == v.tolist()
    for n in (8, 9, 30):
        assert np.array_equal(postprocess.ensemble_table(n, 8),
                              ensemble.overlap_ensemble_coefficients(n, 8))
    frames = torch.randint(0, 256, (7, 5, 6, 3), generator=g, dtype=torch.uint8)
    for k in (7, 6):
        assert np.array_equal(preprocess.median_uint8(frames[:k]).numpy(),
                              median.median_background(frames[:k].numpy(), device="cpu"))
    xy = torch.rand((2, 50, 2), generator=g) * 100
    boxes = torch.cat([xy, xy + 10 + torch.rand((2, 50, 2), generator=g) * 30], -1)
    scores = torch.rand((2, 50), generator=g)
    _, _, _, index, valid = nms.batched_nms(boxes, scores, conf_thres=0.3, iou_thres=0.5,
                                            max_det=8, top_k=32)
    for f in range(2):
        want = index[f][valid[f]].tolist()
        assert postprocess.nms(boxes[f], scores[f], 0.3, 0.5, 32, 8) == want
