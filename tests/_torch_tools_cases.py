"""The scenes the training and quality harness trains on, by digest
(padel_analytics_tpu_torch/tools/). tests/test_torch_tools_data.py holds
each scene maker bit-equal to its JAX demo's and its digest equal to
SCENE_DIGESTS; chip_smoke.py checks the same digests on the card's host, so
the card trains on the data the JAX demos train on. No JAX here: the card's
machine has none."""

import hashlib

import numpy as np

from padel_analytics_tpu_torch.tools import convergence, inpaint_convergence, yolo_convergence
from padel_analytics_tpu_torch.tools import derived_quality as dq


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _rally(n: int) -> str:
    clip = convergence.make_rally(n, 48, 80, np.random.default_rng(0))
    return digest(clip.frames, clip.coords, clip.visibility, clip.median, clip.coords_src)


def _yolo() -> str:
    rng = np.random.default_rng(0)
    return digest(*yolo_convergence.make_scenes(rng, 16), *yolo_convergence.make_scenes(rng, 8))


def _inpaint() -> str:
    train, ev, _ = inpaint_convergence.make_rallies(400)
    return digest(*[a for r in train + [ev] for a in (r.coords_pred, r.coords_gt, r.vis_pred,
                                                       r.vis_gt, r.inpaint_mask)])


def _derived(scale: int) -> str:
    geo = dq.Geometry.at(scale)
    rng = np.random.default_rng(0)
    frames, boxes, kpts = dq.make_scene_clip(rng, 24, geo=geo)
    ev = dq.make_scene_clip(rng, 48, geo=geo)
    views = list(dq._letterbox_train_views(frames, boxes, geo)[:2])
    for s in dq.pose_sizes(geo):
        views += dq._squash_train_views(frames, boxes, kpts, s, geo)
    return digest(frames, boxes, kpts, *ev, *views)


#: Each demo's scenes at its size and seed: the TrackNet rallies of the
#: convergence (72 frames) and stride (96) budgets, the YOLO scenes, the
#: InpaintNet rallies, the derived-quality clips with their letterbox and
#: squash training views at scale 1 and 5.
SCENE_MAKERS = {
    "rally_72": lambda: _rally(72),
    "rally_96": lambda: _rally(96),
    "yolo_scenes": _yolo,
    "inpaint_rallies": _inpaint,
    "derived_scale1": lambda: _derived(1),
    "derived_scale5": lambda: _derived(5),
}

SCENE_DIGESTS = {
    "rally_72": "97d9b811fd85b774a5be27b68c6b857ba9b6aab89048adfc57dd78c60322e1ee",
    "rally_96": "4d0e6015e85a6248450b52320775d4e207b39c818c60598f21de6b13bebe4b41",
    "yolo_scenes": "5b9bc2b6bffe5b88fe65e942e61193cc386ff9f43f58ed377076047f84a21538",
    "inpaint_rallies": "2aea42bbea7e31c916e4f89a6d8df0599e7c5a6645006e2f51ecad33749dfe2b",
    "derived_scale1": "88d60d5ccc8eddd4f559bedd712b1681151d7766510175b909ed6b1eaf09317e",
    "derived_scale5": "f4610fa7defbea6cd1e929d7df2647d725fea164620eb0b89c0ec0482dba10b1",
}


def scene_digests() -> dict[str, str]:
    return {k: f() for k, f in SCENE_MAKERS.items()}
