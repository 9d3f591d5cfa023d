"""Build the package's CUDA kernels and its host C code at first use and
load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, in ``_build/`` beside this
file (listed in ``.gitignore``). Each ``csrc/<name>.c`` (host code: the
checkpoint reader's zstd decoder) is compiled the same way by the host C
compiler, ``$CC`` or else ``cc`` (`host_library`), which needs no card and no
CUDA toolkit. A library is named after a content hash of the source, of every
local header it includes (``#include "..."``, followed recursively) and of
the compiler flags, so a change to any of them gets a fresh build and an
unchanged one is loaded from the library already there. Nothing here runs at
import time.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; `check` raises on a non-zero
code, because a refused launch never runs and a later synchronize would not
report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shlex
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
#: Every compile, include and link flag: all of them enter the library's hash.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: The host C compiler's flags for ``csrc/*.c``: they enter the hash too.
CC_FLAGS = ["-std=c99", "-O2", "-shared", "-fPIC", "-Wall"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_I64 = ctypes.c_int64
# C signature of every entry point, by source file.
SIGNATURES = {
    "conv3x3_bn_act": {
        "conv3x3_bn_act_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "heatmap_cc": {
        "heatmap_cc_decode": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "heatmap_cc_max_active_clusters": [_I, _I, _P],
    },
}
#: C signature (argument types, result type) of every host entry point.
HOST_SIGNATURES = {
    "zstd_decode": {
        "zd_decompress": ([_P, _I64, _P, _I64], _I64),
        "zd_content_size": ([_P, _I64], _I64),
        "zd_crc32c": ([_P, _I64], ctypes.c_uint32),
        "zd_xxh64": ([_P, _I64, ctypes.c_uint64], ctypes.c_uint64),
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


def _cc() -> list[str]:
    """The host C compiler: ``$CC`` (which may carry flags), else ``cc``."""
    cc = shlex.split(os.environ.get("CC") or "cc")
    if not cc or shutil.which(cc[0]) is None:
        raise RuntimeError(
            f"no host C compiler: {cc[0] if cc else '$CC'!r} not found (set CC or install cc); "
            "the checkpoint reader builds csrc/zstd_decode.c with it")
    return cc


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library built from ``csrc/<name>.c`` by the host C
    compiler."""
    key = f"host:{name}"
    with _lock:
        if key not in _loaded:
            lib = ctypes.CDLL(str(_compile(name, host=True)))
            for fn_name, (argtypes, restype) in HOST_SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _loaded[key] = lib
        return _loaded[key]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = _load(name, _compile(name))
        return _loaded[name]


def build(*names: str) -> None:
    """Compile the libraries of `names` not built yet, one nvcc each, all
    started together (`library` then only loads them)."""
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        list(pool.map(_compile, names))


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _local_sources(src: Path) -> list[Path]:
    """`src` and every file it includes with quotes that exists beside the
    including file, recursively, each once."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file():
                todo.append(dep)
    return seen


def library_path(name: str, host: bool = False) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (``.c`` with `host`)
    lives: named by the hash of its local sources and `NVCC_FLAGS`
    (`CC_FLAGS`)."""
    flags = CC_FLAGS if host else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _local_sources((CSRC / f"{name}.{'c' if host else 'cu'}").resolve()):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, host: bool = False) -> Path:
    src = CSRC / f"{name}.{'c' if host else 'cu'}"
    lib_path = library_path(name, host)
    if lib_path.exists():
        build_log.setdefault(name, {"seconds": 0.0, "ptxas": "(cached build)"})
        return lib_path
    compiler = [*_cc(), *CC_FLAGS] if host else [_nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*compiler, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler[0]} failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    build_log[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": (proc.stdout + proc.stderr).strip(),
    }
    return lib_path


def _load(name: str, lib_path: Path) -> ctypes.CDLL:
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
