"""What the benchmark loads: nothing of JAX or the JAX package; the plain
reference nothing of the port either. Top-level names compared whole: the
port's name begins with the JAX package's."""

import json
import os
import subprocess
import sys

from benchmark.cell import FORBIDDEN

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_run_and_reference_load_no_jax():
    top = _loaded("import benchmark.run, benchmark.cell, benchmark.control, benchmark.reference"
                  ".pipeline")
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    top = _loaded("import benchmark.reference.pipeline, benchmark.check, benchmark.flops")
    assert "padel_analytics_tpu_torch" not in top and not top & set(FORBIDDEN)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ref_1080p_rally",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
