"""The one traffic generator: a pool of synthetic rally clips made from a
traffic file's parameters and a seed.

A frame is a court plate (a blue court with white lines, wider than the
frame where the camera pans), a sensor-noise plate (one of a few drawn
once), four walking player figures and a ball on parabolic paths, hidden
in short gaps. Every size is a fraction of the frame, so one traffic file
shape serves every resolution; the seed picks the noise, the players'
starts and the ball's arcs and gaps, never a size or a count.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _court_plate(t: dict, h: int, w: int, margin: int) -> np.ndarray:
    plate = np.empty((h, w + 2 * margin, 3), np.uint8)
    plate[:] = t["court_rgb"]
    for x0, y0, x1, y1 in t["lines"]:
        plate[round(y0 * h): max(round(y1 * h), round(y0 * h) + 2),
              margin + round(x0 * w): margin + max(round(x1 * w), round(x0 * w) + 2)] = \
            t["line_rgb"]
    return plate


def make_pool(t: dict, n_frames: int, seed: int, threads: int = 4) -> list[list[np.ndarray]]:
    """`t["pool_clips"]` clips of `n_frames` RGB uint8 frames."""
    h, w = t["frame_hw"]
    rng = np.random.default_rng(seed)
    pan = t["pan"]
    margin = math.ceil(pan["amplitude"] * w)
    plate = _court_plate(t, h, w, margin)
    noise = [rng.integers(0, t["noise_amplitude"], (h, w, 3), dtype=np.uint8)
             for _ in range(t["noise_plates"])]
    pw, ph = round(t["player_wh"][0] * w), round(t["player_wh"][1] * h)
    r = max(2, round(t["ball_radius"] * h))
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    disk = ys ** 2 + xs ** 2 <= r * r
    clips = []
    for _ in range(t["pool_clips"]):
        starts = [(x + rng.uniform(-0.03, 0.03), y + rng.uniform(-0.03, 0.03))
                  for x, y in t["player_starts"]]
        speeds = rng.uniform(*t["player_speed"], len(starts)) * rng.choice([-1, 1], len(starts))
        phase = rng.uniform(0, 2 * math.pi)
        arc = t["ball_arc_frames"]
        arcs = rng.uniform(0.15, 0.85, (n_frames // arc + 1, 2))
        hidden = np.zeros(n_frames, bool)
        for g in rng.choice(n_frames - 16, t["ball_gaps"], replace=False) + 8:
            hidden[g: g + rng.integers(t["ball_gap_frames"][0], t["ball_gap_frames"][1] + 1)] = True

        def frame(i: int) -> np.ndarray:
            off = margin + round(pan["amplitude"] * w * math.sin(2 * math.pi * i / pan["period"]
                                                                  + phase))
            f = np.add(plate[:, off: off + w], noise[i % len(noise)])
            dx = off - margin
            for (x, y), v, rgb in zip(starts, speeds, t["player_rgb"]):
                cx = int((x * w + v * i * w / 1000.0) % (w * 0.8) + 0.1 * w) - dx
                cy = int(y * h + (i % 16) * h / 1080.0)
                x0, y0 = max(cx, 0), max(cy, 0)
                f[y0: cy + ph, x0: cx + pw] = rgb
                f[max(cy - ph // 5, 0): y0,
                  max(cx + pw // 4, 0): cx + 3 * pw // 4] = (220, 180, 150)
            if not hidden[i]:
                j, k = i % arc, i // arc
                bx = int(((arcs[k, 0] + (j / arc) * (arcs[k, 1] - arcs[k, 0])) * w)) - dx
                by = int(h * (0.8 - 1.6 * (j / arc) * (1 - j / arc)))
                if r <= bx < w - r and r <= by < h - r:
                    f[by - r: by + r + 1, bx - r: bx + r + 1][disk] = t["ball_rgb"]
            return f

        with ThreadPoolExecutor(threads) as pool:
            clips.append(list(pool.map(frame, range(n_frames))))
    return clips
