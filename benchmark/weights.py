"""Seeded weights, made on the device, and their calibration.

Every conv weight is He-normal (N(0, 2 / fan_in); LeCun for InpaintNet's
1-D convs), drawn by one `torch.randn` call a model from a generator on
the device; biases zero, BatchNorm the identity. Under the port's LeCun
init the signal dies out with depth (every output nearly constant), which
no threshold can gate.

Random heads do not gate like trained ones, so each is calibrated, with
the benchmark's own plain reference model on the clip's first frames
(the port's outputs are never read): a YOLOv8 class head is scaled and
shifted in closed form so that about `target` anchors a frame clear the
confidence threshold (for a many-class detector the other classes are
silenced first, so the person class is the best one where it fires); the
model court's keypoint head is set to put its 12 keypoints in a court's
shape around the candidate's anchor (a regular homography); TrackNet's
predictor
is scaled and shifted so that most frames hold one small blob above the
heatmap threshold. The calibrated tensors are what both sides load.
"""

from __future__ import annotations

import math

import torch

from .reference import models
from .reference.models import STRIDES
from .reference.pipeline import POINTS_MAPPER, ReferencePipeline, fp32_exact, scaled
from .reference.preprocess import i420_round_trip


#: The spread (model px) of a calibrated court keypoint about its place in
#: the court's shape, from anchor to anchor.
JITTER = 16.0


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def seeded_state_dict(model: torch.nn.Module, gen: torch.Generator, device) -> dict:
    """He-normal conv weights from one randn call on `device`."""
    sd = {k: torch.zeros(v.shape, device=device) for k, v in model.state_dict().items()}
    convs = [(k, v) for k, v in sd.items() if k.endswith("weight") and v.dim() >= 3]
    draw = torch.randn(sum(v.numel() for _, v in convs), generator=gen, device=device)
    at = 0
    for k, v in convs:
        fan_in = v[0].numel()
        gain = 2.0 if v.dim() == 4 else 1.0
        v.copy_(draw[at: at + v.numel()].view(v.shape) * math.sqrt(gain / fan_in))
        at += v.numel()
    for k, v in sd.items():
        if k.endswith("bn.weight") or k.endswith("running_var"):
            v.fill_(1.0)
        if k.endswith("num_batches_tracked"):
            sd[k] = v.long()
    return sd


def make_weights(cfg: dict, seed: int, device) -> dict:
    """name -> state dict of every model the configuration serves."""
    p, q, b, c = cfg["players"], cfg["pose"], cfg["ball"], cfg["court"]
    nets = {"players": models.YOLOv8(p["variant"], p["num_classes"]),
            "pose": models.YOLOv8(q["variant"], 1, q["num_keypoints"]),
            "tracknet": models.TrackNet(models.tracknet_in_dim(b["seq_len"], b["bg_mode"]),
                                        b["seq_len"])}
    if b.get("inpaintnet"):
        nets["inpaintnet"] = models.InpaintNet()
    if c["mode"] == "yolo":
        nets["court"] = models.YOLOv8(c["variant"], 1, c["num_keypoints"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.device("meta"):
        return {name: seeded_state_dict(net, gen, device) for name, net in nets.items()}


def _cls_head(sd: dict, logits: torch.Tensor, conf: float, target: int) -> None:
    """Scale and shift class 0's projections so that about `target` anchors
    a frame score above `conf`, the top one ~4 logits above the 3*target-th;
    silence every other class (weights 0, bias -20)."""
    top = logits.sort(dim=-1, descending=True).values
    spread = float((top[:, 0] - top[:, 3 * target - 1]).mean())
    scale = 4.0 / max(spread, 1e-6)
    shift = _logit(conf) - scale * float(top[:, target - 1].mean())
    for i in range(3):
        w, bias = sd[f"cls_{i}.proj.weight"], sd[f"cls_{i}.proj.bias"]
        w[0] *= scale
        bias[0] = shift
        w[1:] = 0.0
        bias[1:] = -20.0


def calibrate(cfg: dict, weights: dict, frames: torch.Tensor, device) -> dict:
    """Calibrate `weights` in place on `frames` (a few uint8 source frames
    on the device) with the plain reference; returns what was set."""
    ref = ReferencePipeline(cfg, weights, frames.shape[1:3], device)
    out = {}
    with torch.no_grad(), fp32_exact():
        x = i420_round_trip(frames).float()
        lanes = [("players", ref.det, lambda v: ref.letterbox(v), cfg["players"], 16),
                 ("pose", ref.pose, ref.pose_resize, cfg["pose"], 16)]
        if ref.court is not None:
            lanes.append(("court", ref.court, ref.court_resize, cfg["court"], 2))
        for name, net, prep, lane, target in lanes:
            sd = weights[name]
            for i in range(3):  # the raw logits: bias 0
                sd[f"cls_{i}.proj.bias"].zero_()
            net.load_state_dict(sd)
            o = net(prep(x) / 255.0, raw=True)
            _cls_head(sd, o["cls_logits"][..., 0], lane["conf"], target)
            net.load_state_dict(sd)
            n = (net(prep(x) / 255.0)["scores"][..., 0] > lane["conf"]).sum(-1).float()
            out[name] = {"candidates_a_frame": float(n.mean())}
        if ref.court is not None:
            out["court"]["keypoint_jitter_px"] = _court_keypoints(ref, weights["court"], x)
        out["tracknet"] = _tracknet(ref, weights["tracknet"], frames, x)
    return out


def _keypoint_head(net, resize, size: int, sd: dict, x: torch.Tensor, spread: float,
                   shape: torch.Tensor) -> None:
    """Set a YOLOv8-pose keypoint head as a trained one finds its object:
    each raw (x, y) scaled so that a keypoint spreads `spread` model pixels
    from anchor to anchor, about `shape`'s offset of that keypoint (model
    px, in the head's keypoint order), set by its bias."""
    nk = net.num_keypoints
    for i in range(3):
        sd[f"kpt_{i}.proj.bias"].zero_()
    net.load_state_dict(sd)
    raw = net(resize(x) / 255.0, raw=True)["kpt_raw"][..., :2]
    at = 0
    for i, s in enumerate(STRIDES):
        n = (size // s) ** 2
        std = float(raw[:, at: at + n].std())
        at += n
        w, b = sd[f"kpt_{i}.proj.weight"], sd[f"kpt_{i}.proj.bias"]
        for k in range(nk):
            w[3 * k: 3 * k + 2] *= spread / (2 * s * max(std, 1e-6))
            b[3 * k: 3 * k + 2] = shape[k] / (2 * s)
    net.load_state_dict(sd)


def _court_keypoints(ref, sd: dict, x: torch.Tensor) -> float:
    """The court head put in a court's shape around the candidate's anchor
    (the configuration's `calibration_keypoints`, ids through
    POINTS_MAPPER), JITTER model pixels from anchor to anchor: a regular
    homography. Returns the mean distance (model px) of the best
    candidates' keypoints from the court's shape."""
    c = ref.cfg["court"]
    size = c["train_image_size"]
    pts = torch.tensor(scaled(c["calibration_keypoints"], (size, size)), dtype=torch.float32,
                       device=x.device)
    shape = (pts - pts.mean(dim=0))[[POINTS_MAPPER[i] for i in range(c["num_keypoints"])]]
    _keypoint_head(ref.court, ref.court_resize, size, sd, x, JITTER, shape)
    o = ref.court(ref.court_resize(x) / 255.0)
    best = o["scores"][..., 0].argmax(-1)
    k = o["kpts"][torch.arange(len(best), device=best.device), best][..., :2]
    return float((k - k.mean(dim=1, keepdim=True) - shape).abs().mean())


def _tracknet(ref, sd: dict, frames: torch.Tensor, x: torch.Tensor) -> dict:
    """Scale and shift TrackNet's predictor: the logits' top pixel ~3 above
    the 64th-largest on each window's map, then the shift that leaves ~85%
    of the frames with a pixel above the 0.5 threshold in the ensemble of
    the windows covering them (the mean of their sigmoid maps)."""
    b = ref.cfg["ball"]
    seq = b["seq_len"]
    sd["predictor.bias"].zero_()
    ref.tracknet.load_state_dict(sd)
    small = torch.clamp(torch.floor(ref.ball_resize(x.flip(-1)) + 0.5), 0, 255)
    med = small.median(dim=0).values
    n = len(small) - seq + 1
    win = torch.stack([torch.cat([med] + [small[w + j] for j in range(seq)], -1)
                       for w in range(n)]) / 255.0
    z = ref.tracknet(win, logits=True).permute(0, 3, 1, 2)  # (n, seq, H, W)
    flat = z.reshape(n * seq, -1)
    top = torch.topk(flat, 64, dim=-1).values
    scale = 3.0 / max(float((top[:, 0] - top[:, 63]).mean()), 1e-6)
    covered = [(f, [(w, f - w) for w in range(max(0, f - seq + 1), min(f, n - 1) + 1)])
               for f in range(len(small))]
    covered = [c for f, c in covered if len(c) >= seq // 2]

    def visible(shift: float) -> float:
        hits = [float((torch.stack([torch.sigmoid(scale * z[w, c] + shift) for w, c in cov])
                       .mean(0) > 0.5).any()) for cov in covered]
        return sum(hits) / len(hits)

    lo, hi = -50.0, 50.0
    for _ in range(30):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if visible(mid) < 0.85 else (lo, mid)
    sd["predictor.weight"] *= scale
    sd["predictor.bias"].fill_(hi)
    ref.tracknet.load_state_dict(sd)
    return {"logit_scale": scale, "logit_shift": hi, "visible_share": visible(hi)}
