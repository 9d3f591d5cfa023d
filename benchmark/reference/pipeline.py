"""The plain reference of one configuration's main path: the answers the
port's trackers should give on a clip, from the same frames and weights,
in float32 with TF32 off (or, with `quant`, in the control's precision).

`ReferencePipeline(cfg, weights, src_hw, device).run(frames)` returns an
`Answers`: per frame the players' boxes (NMS, polygon gate), the pose
detections' keypoints, the ball row (ensemble, decode, inpaint), the court
keypoints, plus the candidates every answer is matched against. Frames go
through the port's default wire format (the I420 round trip) first; the
ball's median comes from the source frames, as in the port's fused run.
Everything runs in blocks of `block` frames so that it fits beside nothing
else on the card.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from . import models, postprocess
from .preprocess import Letterbox, Resize, i420_round_trip, median_uint8

#: The reference repository's court-keypoint id of each yolo keypoint index.
POINTS_MAPPER = {0: 10, 1: 11, 2: 1, 3: 0, 4: 7, 5: 9, 6: 8, 7: 5, 8: 6, 9: 2, 10: 4, 11: 3}
#: Most candidates kept a frame for matching (by score).
KEEP = 4096


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for convs and matmuls inside the block."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@dataclass
class Candidates:
    """One lane's candidates in one frame, best first: each one's answer
    (a box in source px, or keypoints), score, box in the model's input
    (where NMS compares them) and anchor index; and the anchor indices of
    the detections the reference kept (after NMS and, for the players, the
    polygon gate)."""

    answer: np.ndarray
    score: np.ndarray
    nms_box: np.ndarray
    anchor: np.ndarray
    kept: np.ndarray


@dataclass
class Answers:
    """What a run produced for one clip, in source pixels. `players[f]`:
    (D, 5) x1 y1 x2 y2 confidence; `pose[f]`: (D, 13, 2); `ball`: (N, 3)
    x y visibility; `court[f]`: (12, 2) in id order or None. The
    reference also fills `cands`: per keypoint lane and frame the
    candidates (keypoints, scores, anchors, `Candidates`), per frame the
    players' `Candidates`, and the ball's ensemble heatmaps (on the
    device), each frame's peak, every blob's centre and the visibility
    before InpaintNet."""

    players: list = field(default_factory=list)
    pose: list = field(default_factory=list)
    ball: np.ndarray = None
    court: list = field(default_factory=list)
    cands: dict = field(default_factory=dict)


def scaled(points, hw) -> np.ndarray:
    """Points given as fractions of the frame's (width, height) -> pixels."""
    h, w = hw
    return np.asarray(points, np.float64) * (w, h)


class ReferencePipeline:
    def __init__(self, cfg: dict, weights: dict, src_hw, device, quant=None, block: int = 8):
        self.cfg, self.src_hw, self.device, self.block = cfg, tuple(src_hw), device, block
        p, q, b, c = cfg["players"], cfg["pose"], cfg["ball"], cfg["court"]
        self.det = models.YOLOv8(p["variant"], p["num_classes"])
        self.pose = models.YOLOv8(q["variant"], 1, q["num_keypoints"])
        self.tracknet = models.TrackNet(models.tracknet_in_dim(b["seq_len"], b["bg_mode"]),
                                        b["seq_len"])
        nets = {"players": self.det, "pose": self.pose, "tracknet": self.tracknet}
        self.inpaint = None
        if b.get("inpaintnet"):
            self.inpaint = nets["inpaintnet"] = models.InpaintNet()
        self.court = None
        if c["mode"] == "yolo":
            self.court = nets["court"] = models.YOLOv8(c["variant"], 1, c["num_keypoints"])
        for name, net in nets.items():
            net.load_state_dict(weights[name])
            models.set_quant(net.to(device).eval(), quant)
        self.letterbox = Letterbox(self.src_hw, p["imgsz"], device)
        s = q["train_image_size"]
        self.pose_resize = Resize(self.src_hw, (s, s), "pil_bicubic", device)
        self.ball_resize = Resize(self.src_hw, (b["height"], b["width"]), "pil_bicubic", device)
        if self.court is not None:
            s = c["train_image_size"]
            self.court_resize = Resize(self.src_hw, (s, s), "pil_bicubic", device)

    # -- lanes -------------------------------------------------------------

    def _players(self, x, out: Answers) -> None:
        p = self.cfg["players"]
        h, w = self.src_hw
        o = self.det(self.letterbox(x) / 255.0)
        boxes = self.letterbox.to_source(o["boxes"])
        lim = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
        boxes = torch.minimum(boxes.clamp(min=0), lim)
        s = o["scores"]
        person = s[..., 0] if s.shape[-1] == 1 else torch.where(
            s.argmax(-1) == 0, s[..., 0], torch.zeros_like(s[..., 0]))
        poly = scaled(p["polygon"], self.src_hw)
        for f in range(len(x)):
            keep = postprocess.nms(o["boxes"][f], person[f], p["conf"], p["iou"],
                                   p["nms_top_k"], p["max_detections"])
            bx = boxes[f, keep].double().cpu().numpy()
            feet = np.stack([(bx[:, 0] + bx[:, 2]) / 2, bx[:, 3]], -1)
            gate = postprocess.in_polygon(feet, poly) if len(bx) else np.zeros(0, bool)
            sc = person[f, keep].double().cpu().numpy()
            out.players.append(np.concatenate([bx, sc[:, None]], -1)[gate])
            top = self._top(person[f], p["conf"])
            out.cands["players"].append(Candidates(
                boxes[f, top].double().cpu().numpy(), person[f, top].double().cpu().numpy(),
                o["boxes"][f, top].double().cpu().numpy(), top.cpu().numpy(),
                np.asarray(keep, np.int64)[gate]))

    def _anchors(self, size: int, device) -> torch.Tensor:
        """(A, 2) anchor centres of a size x size input in source px, in the
        head's anchor order."""
        h, w = self.src_hw
        out = []
        for s in models.STRIDES:
            n = size // s
            ys, xs = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
            out.append(torch.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1) * s)
        return (torch.cat(out) * torch.tensor([w / size, h / size])).to(device)

    def _keypoint_lane(self, net, resize, size, lane: dict, x, max_det: int):
        """(per frame: the NMS detections' keypoints (D, K, 2) source px, per
        frame: the candidates (keypoints, scores, anchor centres)) of a
        YOLOv8-pose lane."""
        h, w = self.src_hw
        o = net(resize(x) / 255.0)
        k = o["kpts"][..., :2] * torch.tensor([w / size, h / size], device=x.device)
        anchors = self._anchors(size, x.device)
        sc = o["scores"][..., 0]
        kept, cands = [], []
        for f in range(len(x)):
            keep = postprocess.nms(o["boxes"][f], sc[f], lane["conf"], lane["iou"],
                                   lane["nms_top_k"], max_det)
            kept.append(k[f, keep].cpu().numpy())
            top = self._top(sc[f], lane["conf"])
            c = Candidates(k[f, top].cpu().numpy(), sc[f, top].double().cpu().numpy(),
                           o["boxes"][f, top].double().cpu().numpy(), top.cpu().numpy(),
                           np.asarray(keep, np.int64))
            cands.append((c.answer, c.score, anchors[top].cpu().numpy(), c))
        return kept, cands

    @staticmethod
    def _top(scores: torch.Tensor, conf: float) -> torch.Tensor:
        """The candidates a frame's answers are matched against: every
        anchor scoring above half the threshold, best first (at least one,
        at most KEEP); a stable sort keeps the lowest anchors of a tie
        (saturated scores tie at 1) first, as the port's NMS does."""
        order = torch.sort(scores, descending=True, stable=True).indices
        return order[:int((scores > conf / 2).sum().clamp(1, KEEP))]

    def _pose(self, x, out: Answers) -> None:
        q = self.cfg["pose"]
        kept, cands = self._keypoint_lane(self.pose, self.pose_resize, q["train_image_size"], q,
                                          x, q["max_detections"])
        out.pose += kept
        out.cands["pose"] += cands

    def _court(self, x, out: Answers) -> None:
        c = self.cfg["court"]
        order = [i for i, _ in sorted(POINTS_MAPPER.items(), key=lambda kv: kv[1])]
        kept, cands = self._keypoint_lane(self.court, self.court_resize, c["train_image_size"],
                                          c, x, 1)
        out.court += [k[0][order] if len(k) else None for k in kept]
        out.cands["court"] += [(k[:, order], s, a) for k, s, a, _ in cands]

    def _ball(self, frames: torch.Tensor, out: Answers) -> None:
        b = self.cfg["ball"]
        n, (h, w) = len(frames), self.src_hw
        seq = b["seq_len"]
        head = min(n, b["median_max_sample_num"])
        median = median_uint8(frames[:head])
        med = torch.clamp(torch.floor(self.ball_resize(median[None]) + 0.5), 0, 255)[0]
        small = []
        for i in range(0, n, self.block):
            x = i420_round_trip(frames[i: i + self.block]).float()
            swap = (torch.arange(i, i + len(x), device=x.device) < head)[:, None, None, None]
            x = torch.where(swap, x.flip(-1), x)
            small.append(torch.clamp(torch.floor(self.ball_resize(x) + 0.5), 0, 255))
        small = torch.cat(small)
        coef = torch.from_numpy(postprocess.ensemble_table(n, seq)).to(frames.device)
        ens = torch.zeros((n,) + tuple(small.shape[1:3]), device=frames.device)
        nw = n - seq + 1
        for w0 in range(0, nw, self.block):
            ws = range(w0, min(w0 + self.block, nw))
            x = torch.stack([torch.cat([med] + [small[v + j] for j in range(seq)], -1)
                             for v in ws]) / 255.0
            y = self.tracknet(x)
            back = seq - 1 - torch.arange(seq, device=frames.device)
            for i, v in enumerate(ws):
                # Window v's channel j is frame v + j's, weighted as the table
                # weights window v for that frame.
                f = torch.arange(v, v + seq, device=frames.device)
                ens[f] += coef[f, back][:, None, None] * y[i].permute(2, 0, 1)
        cx, cy, vis, centers = postprocess.decode_heatmaps(ens, centers=True)
        out.cands["ball_peak"] = ens.amax(dim=(1, 2)).cpu().numpy()
        out.cands["ball_heat"] = ens
        ws, hs = w / b["width"], h / b["height"]
        xs = [int(int(v) * ws) for v in cx.tolist()]
        ys = [int(int(v) * hs) for v in cy.tolist()]
        out.cands["ball"] = [np.array([[int(int(x) * ws), int(int(y) * hs)]
                                       for x, y in c.tolist()], np.float64).reshape(-1, 2)
                             for c in centers]
        vs = vis.tolist()
        out.cands["ball_pre_vis"] = np.array(vs)
        if self.inpaint is not None:
            xs, ys, vs = postprocess.inpaint(self.inpaint, xs, ys, vs, self.src_hw,
                                             (b["height"], b["width"]), b["inpaint_seq_len"],
                                             frames.device)
        out.ball = np.array([xs, ys, vs], np.int64).T

    def run(self, frames: torch.Tensor) -> Answers:
        """(N, H, W, 3) uint8 source frames on the device -> Answers."""
        out = Answers(cands={"pose": [], "court": [], "players": []})
        with torch.no_grad(), fp32_exact():
            for i in range(0, len(frames), self.block):
                x = i420_round_trip(frames[i: i + self.block]).float()
                self._players(x, out)
                self._pose(x, out)
                if self.court is not None:
                    self._court(x, out)
            self._ball(frames, out)
        return out
