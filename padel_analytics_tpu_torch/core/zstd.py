"""Zstandard frames and CRC-32C through the hand-written decoder in
``csrc/zstd_decode.c``, built by the host C compiler at first use
(`_build.host_library`). No zstd package is used, and there is no fallback:
without a compiler the first read raises, naming it.

Every error names what was being read (`what`, a file or a key), so a
malformed checkpoint says which file is at fault.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

#: The decoder's error codes (csrc/zstd_decode.c, ZD_E_*).
ERRORS = {
    -1: "bad magic number (not a zstd frame)",
    -2: "a reserved bit or block type is set",
    -3: "truncated frame",
    -4: "bad FSE or Huffman table",
    -5: "corrupt bitstream, length or offset",
    -6: "content checksum mismatch",
    -7: "output larger than expected",
    -8: "the frame needs a dictionary (not supported)",
    -9: "window larger than 2 GiB (not supported)",
    -10: "content size differs from the frame header's",
    -11: "out of memory",
}
_DST_SMALL = -7


def _lib() -> ctypes.CDLL:
    return _build.host_library("zstd_decode")


def _view(data) -> np.ndarray:
    """`data` (bytes, bytearray, memoryview) as uint8, without a copy."""
    return np.frombuffer(data, np.uint8)


def content_size(data) -> int:
    """The decompressed size of `data`'s frames when their headers give it,
    else -1."""
    src = _view(data)
    return int(_lib().zd_content_size(src.ctypes.data, src.size))


#: The most a frame without a content size may decode to (an OCDBT node's
#: body is far smaller).
MAX_UNSIZED = 1 << 34


def decompress(data, what: str) -> bytes:
    """The content of the zstd frames in `data`: into the size their headers
    give, else into a buffer grown up to `MAX_UNSIZED` bytes. Raises
    ValueError naming `what` on a malformed frame."""
    lib = _lib()
    src = _view(data)
    cap = int(lib.zd_content_size(src.ctypes.data, src.size))
    grow = cap < 0
    if grow:
        cap = max(1 << 16, 4 * src.size)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = int(lib.zd_decompress(src.ctypes.data, src.size, out.ctypes.data, cap))
        if n == _DST_SMALL and grow and cap < MAX_UNSIZED:
            cap = min(MAX_UNSIZED, 4 * cap)
            continue
        if n < 0:
            raise ValueError(f"{what}: zstd: {ERRORS.get(n, f'error {n}')}")
        return out[:n].tobytes()


def crc32c(data) -> int:
    """The CRC-32C (Castagnoli) of `data`."""
    buf = _view(data)
    return int(_lib().zd_crc32c(buf.ctypes.data, buf.size))


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of `data` (zstd's content checksum is its low 32 bits)."""
    buf = _view(data)
    return int(_lib().zd_xxh64(buf.ctypes.data, buf.size, seed))


def decompress_into(data, out: np.ndarray, what: str) -> None:
    """Decompress `data` straight into the C-contiguous array `out`, whose
    byte size must be the content's (a zarr chunk's)."""
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError(f"{what}: the output array must be C-contiguous and writeable")
    src = _view(data)
    n = int(_lib().zd_decompress(src.ctypes.data, src.size, out.ctypes.data, out.nbytes))
    if n < 0:
        raise ValueError(f"{what}: zstd: {ERRORS.get(n, f'error {n}')}")
    if n != out.nbytes:
        raise ValueError(f"{what}: zstd: {n} bytes decoded, expected {out.nbytes}")
