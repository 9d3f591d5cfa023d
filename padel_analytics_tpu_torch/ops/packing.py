"""One buffer per device->host download.

A sub-step's results (tensors of several dtypes, each with the frame axis
first) travel as ONE (B, nbytes) uint8 buffer: one copy, one event, one
wait, instead of one synchronous `.cpu()` per tensor. `pack_rows` returns
the buffer and its layout; `unpack_rows` restores the tensors from the
buffer (or from any run of its rows) on whatever device it now lies.
"""

from __future__ import annotations

from typing import Sequence

import torch

Layout = tuple[tuple[torch.dtype, tuple[int, ...]], ...]


def pack_rows(tensors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, Layout]:
    """(B, ...) tensors of any dtypes -> ((B, nbytes) uint8, layout)."""
    b = tensors[0].shape[0]
    layout = tuple((t.dtype, tuple(t.shape[1:])) for t in tensors)
    if any(t.shape[0] != b for t in tensors):
        raise ValueError(f"tensors differ in their first axis: {[tuple(t.shape) for t in tensors]}")
    rows = [t.contiguous().view(torch.uint8).reshape(b, -1) for t in tensors]
    return torch.cat(rows, dim=1), layout


def unpack_rows(buf: torch.Tensor, layout: Layout) -> list[torch.Tensor]:
    """Inverse of `pack_rows` on (B', nbytes) rows of its buffer."""
    b = buf.shape[0]
    out, offset = [], 0
    for dtype, shape in layout:
        n = dtype.itemsize
        for d in shape:
            n *= d
        part = buf[:, offset: offset + n].contiguous().view(dtype)
        out.append(part.reshape((b,) + shape))
        offset += n
    if offset != buf.shape[1]:
        raise ValueError(f"layout holds {offset} bytes a row, the buffer {buf.shape[1]}")
    return out
