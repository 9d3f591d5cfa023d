"""Golden comparison of two prediction-cache JSON files.

A copy of ``padel_analytics_tpu/apps/compare_predictions.py``: JSON and
numpy only. The reference's JSON prediction caches (its tracker.py) are the
fixtures of a cross-implementation check: this tool compares a cache
written by one run (the port's, the JAX package's, the reference's) with
another's and reports per-frame pixel distances, the north-star
"detections within 1 px" check. A JAX-package cache against a port cache is
just two files.

Usage:
  python -m padel_analytics_tpu_torch.apps.compare_predictions KIND A.json B.json
  KIND in {players, ball, keypoints, players_keypoints}
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def compare_ball(a, b):
    dists = []
    vis_match = 0
    n = min(len(a), len(b))
    for i in range(n):
        xa, ya = a[i]["xy"]
        xb, yb = b[i]["xy"]
        dists.append(float(np.hypot(xa - xb, ya - yb)))
        vis_match += a[i]["visibility"] == b[i]["visibility"]
    # inf sentinel like the keypoints comparators: an empty cache yields
    # a well-formed report, not a numpy reduction crash.
    arr = np.array(dists) if dists else np.array([np.inf])
    return {
        "frames": n,
        "mean_px": float(arr.mean()),
        "p95_px": float(np.percentile(arr, 95)),
        "max_px": float(arr.max()),
        "within_1px": float((arr <= 1.0).mean()),
        "visibility_agreement": vis_match / max(n, 1),
    }


def compare_keypoints(a, b):
    dists = []
    n = min(len(a), len(b))
    for i in range(n):
        ka = {k["id"]: k["xy"] for k in a[i]}
        kb = {k["id"]: k["xy"] for k in b[i]}
        for kid in set(ka) & set(kb):
            dists.append(float(np.hypot(ka[kid][0] - kb[kid][0], ka[kid][1] - kb[kid][1])))
    arr = np.array(dists) if dists else np.array([np.inf])
    return {
        "frames": n,
        "points": len(dists),
        "mean_px": float(arr.mean()),
        "max_px": float(arr.max()),
        "within_1px": float((arr <= 1.0).mean()),
    }


def compare_players(a, b):
    """Greedy center-distance matching per frame; reports box-center
    distance, IoU, count and ID agreement."""
    center_d, ious, id_match, count_match = [], [], 0, 0
    n = min(len(a), len(b))
    for i in range(n):
        pa, pb = a[i], b[i]
        count_match += len(pa) == len(pb)
        used = set()
        for da in pa:
            ba = np.array(da["xyxy"])
            ca = np.array([(ba[0] + ba[2]) / 2, (ba[1] + ba[3]) / 2])
            best, best_j = None, None
            for j, db in enumerate(pb):
                if j in used:
                    continue
                bb = np.array(db["xyxy"])
                cb = np.array([(bb[0] + bb[2]) / 2, (bb[1] + bb[3]) / 2])
                d = float(np.linalg.norm(ca - cb))
                if best is None or d < best:
                    best, best_j = d, j
            if best_j is None:
                continue
            used.add(best_j)
            db = pb[best_j]
            bb = np.array(db["xyxy"])
            center_d.append(best)
            lt = np.maximum(ba[:2], bb[:2])
            rb = np.minimum(ba[2:], bb[2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[0] * wh[1]
            area = (
                (ba[2] - ba[0]) * (ba[3] - ba[1])
                + (bb[2] - bb[0]) * (bb[3] - bb[1])
                - inter
            )
            ious.append(float(inter / max(area, 1e-9)))
            id_match += da.get("id") == db.get("id")
    m = len(center_d)
    return {
        "frames": n,
        "matches": m,
        "count_agreement": count_match / max(n, 1),
        "mean_center_px": float(np.mean(center_d)) if m else None,
        "within_1px": float(np.mean(np.array(center_d) <= 1.0)) if m else None,
        "mean_iou": float(np.mean(ious)) if m else None,
        "id_agreement": id_match / max(m, 1),
    }


def compare_players_keypoints(a, b):
    dists = []
    n = min(len(a), len(b))
    for i in range(n):
        for da, db in zip(a[i], b[i]):
            ka = {k["name"]: k["xy"] for k in da["player_keypoints"]}
            kb = {k["name"]: k["xy"] for k in db["player_keypoints"]}
            for name in set(ka) & set(kb):
                dists.append(
                    float(np.hypot(ka[name][0] - kb[name][0], ka[name][1] - kb[name][1]))
                )
    arr = np.array(dists) if dists else np.array([np.inf])
    return {
        "frames": n,
        "points": len(dists),
        "mean_px": float(arr.mean()),
        "max_px": float(arr.max()),
        "within_1px": float((arr <= 1.0).mean()),
    }


COMPARATORS = {
    "ball": compare_ball,
    "keypoints": compare_keypoints,
    "players": compare_players,
    "players_keypoints": compare_players_keypoints,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="compare_predictions")
    parser.add_argument("kind", choices=sorted(COMPARATORS))
    parser.add_argument("file_a")
    parser.add_argument("file_b")
    args = parser.parse_args(argv)
    with open(args.file_a) as f:
        a = json.load(f)
    with open(args.file_b) as f:
        b = json.load(f)
    report = COMPARATORS[args.kind](a, b)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
