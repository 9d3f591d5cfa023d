"""What the port's read of the committed JAX-written orbax checkpoint is
held to, with no JAX (chip_smoke.py phase 18 (e) imports this on the card's
host; tests/test_torch_orbax.py on the CPU): the fixture's paths, each
leaf's digest, and the decoder's rate over a directory's zstd chunks. The
fixture is written by tests/_torch_orbax_fixture.py.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

DATA = Path(__file__).with_name("data_torch")
FIXTURE = DATA / "orbax_jax"
DIGESTS = DATA / "orbax_jax.sha256.json"


def digest(leaf) -> dict:
    """{"sha256", "dtype", "shape"} of a numpy array or a torch tensor
    (bfloat16 by its bits, dtype "bfloat16")."""
    dtype = str(leaf.dtype)
    if dtype in ("torch.bfloat16", "bfloat16"):
        import torch

        bits = (leaf.view(torch.int16).numpy() if isinstance(leaf, torch.Tensor)
                else np.asarray(leaf).view(np.int16))
        return {"sha256": hashlib.sha256(np.ascontiguousarray(bits).tobytes()).hexdigest(),
                "dtype": "bfloat16", "shape": list(bits.shape)}
    arr = np.asarray(leaf)
    return {"sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest(),
            "dtype": arr.dtype.name, "shape": list(arr.shape)}


def leaves(tree, prefix: str = "") -> dict:
    """{"a.b.0": leaf} of a tree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        out.update(leaves(v, name + ".") if isinstance(v, (dict, list)) else {name: v})
    return out


def decoder_rate(root, repeats: int = 1) -> dict:
    """The port's read of the OCDBT orbax directory `root`: wall ms of
    `load_checkpoint`, then the zstd decoder alone over every compressed
    zarr chunk, `repeats` times: decoded MB (2**20 bytes), compressed MB,
    seconds and decoded MB/s."""
    import time

    from padel_analytics_tpu_torch.core import zstd
    from padel_analytics_tpu_torch.core.checkpoint import load_checkpoint
    from padel_analytics_tpu_torch.core.ocdbt import OcdbtReader

    t0 = time.perf_counter()
    load_checkpoint(root)
    load_ms = (time.perf_counter() - t0) * 1e3
    reader = OcdbtReader(root)
    chunks = []
    for key in reader.list_keys():
        name, _, leaf = key.rpartition("/")
        if leaf == ".zarray":
            continue
        meta = json.loads(reader.read(f"{name}/.zarray"))
        if meta["compressor"] is None:
            continue
        itemsize = 2 if meta["dtype"] == "bfloat16" else np.dtype(meta["dtype"]).itemsize
        chunks.append((key, reader.read(key), np.empty(int(np.prod(meta["chunks"])) * itemsize,
                                                       np.uint8)))
    t0 = time.perf_counter()
    for _ in range(repeats):
        for key, data, out in chunks:
            zstd.decompress_into(data, out, key)
    seconds = time.perf_counter() - t0
    decoded = repeats * sum(out.nbytes for _, _, out in chunks) / 2**20
    return {"load_ms": load_ms, "decoded_MB": decoded,
            "compressed_MB": repeats * sum(len(d) for _, d, _ in chunks) / 2**20,
            "chunks": len(chunks) * repeats, "decode_s": seconds, "MB_per_s": decoded / seconds}
