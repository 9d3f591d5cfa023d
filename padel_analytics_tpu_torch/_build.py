"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, named after the source's
content hash, in ``_build/`` beside this file (listed in ``.gitignore``). A
changed source gets a new hash and so a fresh build; an unchanged one is
loaded from the library already there. Nothing here runs at import time.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; `check` raises on a non-zero
code, because a refused launch never runs and a later synchronize would not
report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point, by source file.
SIGNATURES = {
    "conv3x3_bn_act": {
        "conv3x3_bn_act_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "heatmap_cc": {
        "heatmap_cc_decode": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: Per library: {"seconds": build time (0.0 when loaded from _build/),
#: "ptxas": the compiler's register/shared-memory report}.
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = _build_and_load(name)
        return _loaded[name]


def _build_and_load(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(exist_ok=True)
    lib_path = BUILD_DIR / f"{name}-{digest}.so"
    if lib_path.exists():
        build_log[name] = {"seconds": 0.0, "ptxas": "(cached build)"}
    else:
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        build_log[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": (proc.stdout + proc.stderr).strip(),
        }
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
