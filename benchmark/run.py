"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and last `compared`: each number the check compared, beside its limit);
the compared numbers are also the last lines of standard error. A run
that finds no card, or fewer than the cell asks for, exits non-zero and
prints no result, as does one whose process has loaded JAX or the JAX
package.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Keep every cache inside the checkout, at fixed paths: the kernels
    build into the package's own _build/ there; Triton, if anything loads
    it, and the extension loader write here."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "benchmark" / ".cache" / sub)
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from .cell import forbidden_modules, run
    from .manifest import Manifest

    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.manual_seed(args.seed)
    result, compared = run(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                           T_PROCESS)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the process loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
