"""The control of the comparison that decides `correct`: the plain
reference put in the program's place and computed one precision below the
configuration's bfloat16 (every conv's input and weight rounded to float8
e4m3 with a per-tensor scale), judged by the same numbers against the
float32 reference on the same clip a run checks. It has to come out not
correct: its readings are the upper ends the limits are set below.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

One JSON line a seed on standard output. It needs no measured window: the
control runs no program.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def readings(manifest, workload: str, seed: int, device: str = "cuda") -> dict:
    """The control's compared numbers for one seed."""
    from . import check
    from .cell import Cell
    from .reference.models import fp8_quant
    from .reference.pipeline import ReferencePipeline

    cell = Cell(manifest, workload, seed, device)
    cell.prepare()
    frames = torch.from_numpy(np.stack(cell.pool[(cell.checked_clip() + 1) % len(cell.pool)]))
    frames = frames.to(device)
    ref = ReferencePipeline(cell.cfg, cell.wts, cell.hw, device).run(frames)
    low = ReferencePipeline(cell.cfg, cell.wts, cell.hw, device, quant=fp8_quant).run(frames)
    nums, basis = check.numbers(low, ref, cell.cfg, cell.hw)
    return {"workload": workload, "seed": seed, "numbers": nums, "basis": basis,
            "correct": check.verdict(nums, cell.limits)}


def main(argv=None) -> int:
    from .manifest import Manifest

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest()
    for seed in args.seeds:
        print(json.dumps(readings(manifest, args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
