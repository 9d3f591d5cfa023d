"""The committed JAX-written orbax checkpoint (tests/data_torch/orbax_jax/)
and its digests (tests/data_torch/orbax_jax.sha256.json): a seeded tree
written by the JAX package's `core/checkpoint.py::save_checkpoint`, which
the port reads on the card's host (chip_smoke.py phase 18 (e)), where there
is no orbax to write one. The tree holds a float32 leaf of 432 KiB of
N(0, 0.02) weights (stored in an OCDBT data file, not inline; four zstd
blocks, which the card's host times the decoder on), a bfloat16 leaf, a 0-d
int32, float64 leaves and a list.

Regenerate (the bytes differ run to run, the leaves and digests do not):

  JAX_PLATFORMS=cpu python tests/_torch_orbax_fixture.py

Time the port's read of a full-width YOLOv8m (80 classes) directory the JAX
package writes, and its decoder alone (`decoder_rate`, one JSON line):

  JAX_PLATFORMS=cpu python tests/_torch_orbax_fixture.py --bench-yolov8m

The digests and the rate are tests/_torch_orbax_cases.py's (no JAX there).
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np

from _torch_orbax_cases import DIGESTS, FIXTURE, decoder_rate, digest, leaves


def seeded_tree():
    import jax.numpy as jnp

    rng = np.random.default_rng(15)
    return {
        "params": {
            "conv": {"kernel": rng.normal(0, 0.02, (3, 3, 48, 256)).astype(np.float32),
                     "bias": rng.normal(0, 0.02, 256).astype(np.float32)},
            "head": {"kernel": np.asarray(jnp.asarray(
                rng.normal(0, 0.5, (24, 12)).astype(np.float32)).astype(jnp.bfloat16))},
        },
        "batch_stats": {"conv": {"mean": rng.normal(0, 1, 256).astype(np.float64),
                                 "var": rng.uniform(0.5, 1.5, 256).astype(np.float64)}},
        "step": np.int32(1500),
        "schedule": [np.arange(5, dtype=np.int64), np.linspace(0, 1, 7).astype(np.float32)],
    }


def bench_yolov8m() -> dict:
    """A full-width YOLOv8m detector (80 classes, seeded weights) written by
    the JAX package's save_checkpoint to a temporary directory, read by the
    port (`decoder_rate`)."""
    import tempfile

    import torch

    from padel_analytics_tpu.core.checkpoint import save_checkpoint
    from padel_analytics_tpu_torch.models.convert import flax_from_state_dict
    from padel_analytics_tpu_torch.models.layers import truncated_lecun_normal_
    from padel_analytics_tpu_torch.models.yolov8 import YOLOv8

    model = truncated_lecun_normal_(YOLOv8("m", 80), torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "yolov8m"
        save_checkpoint(flax_from_state_dict(model.state_dict()), str(root))
        disk = sum(p.stat().st_size for p in root.rglob("*") if p.is_file()) / 2**20
        return {"what": "YOLOv8m detect, 80 classes, JAX save_checkpoint", "disk_MB": disk,
                **decoder_rate(root), "second_read": decoder_rate(root)}


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    if "--bench-yolov8m" in sys.argv:
        print(json.dumps(bench_yolov8m()))
        return 0
    from padel_analytics_tpu.core.checkpoint import save_checkpoint

    tree = seeded_tree()
    shutil.rmtree(FIXTURE, ignore_errors=True)
    save_checkpoint(tree, str(FIXTURE))
    DIGESTS.write_text(json.dumps({k: digest(v) for k, v in leaves(tree).items()}, indent=1,
                                  sort_keys=True) + "\n")
    print(f"wrote {FIXTURE} and {DIGESTS}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
