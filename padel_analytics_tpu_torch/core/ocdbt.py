"""OCDBT databases (tensorstore's Optionally-Cooperative Distributed
B+Tree), read-only: the key-value store under the JAX package's orbax
checkpoint directories (``"use_ocdbt": true`` in ``_METADATA``).

A database is a directory. Its ``manifest.ocdbt`` (or, with numbered
manifests, the highest ``manifest.<16 hex digits>``) holds the config and
the version tree; the latest version names the root of a B+tree whose
nodes and out-of-line values live in data files (``d/<name>``, and under
orbax ``ocdbt.process_<i>/d/<name>``), each found by (file, offset,
length). Every manifest and node is a file or a byte range of a data file
framed as

    magic (uint32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node)
    length (uint64 little-endian, the whole framed size)
    version (varint, 0)   compression (varint: 0 none, 1 zstd)
    body (zstd-compressed through core/zstd.py when compression is 1)
    crc32c (uint32 little-endian, over every byte before it)

and a body is built of varints, little-endian fixed-width ints and
columns (each field of every entry, then the next field). Keys are stored
prefix-compressed: an entry keeps the length of the prefix it shares with
the entry before it and its own suffix; an interior node's child stores its
keys after the prefix common to its subtree, which the parent records.

Only the latest version is read. Nothing is written. A malformed file
raises ValueError naming it.
"""

from __future__ import annotations

import os
import re
import struct
from pathlib import Path
from typing import NamedTuple, Union

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = 2**64 - 1  # offset and length of an empty version's root
_NUMBERED = re.compile(r"manifest\.[0-9a-f]{16}")


class _Body:
    """A cursor over a decoded body; errors name `what`."""

    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def fail(self, msg: str) -> ValueError:
        return ValueError(f"{self.what}: OCDBT: {msg} (byte {self.pos})")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise self.fail(f"truncated (want {n} more bytes)")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift >= 64:
                raise self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of one framed manifest or node: magic, length, version and
    CRC-32C checked, zstd decompressed."""
    if len(data) < 18:
        raise ValueError(f"{what}: OCDBT: {len(data)} bytes is too short for a framed file")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: OCDBT: bad magic 0x{got:08x} (want 0x{magic:08x})")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{what}: OCDBT: header length {length} != {len(data)} bytes")
    crc = struct.unpack("<I", data[-4:])[0]
    if zstd.crc32c(memoryview(data)[:-4]) != crc:
        raise ValueError(f"{what}: OCDBT: CRC-32C mismatch")
    head = _Body(data[:-4], what)
    head.pos = 12
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT: format version {version} (this reader takes 0)")
    compression = head.varint()
    body = data[head.pos: -4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, what)
    raise ValueError(f"{what}: OCDBT: unknown compression format {compression}")


class DataFile(NamedTuple):
    base: str  # the base path, from the database root
    path: str  # the whole path, from the database root


class Ref(NamedTuple):
    """(file, offset, length) of a node or an out-of-line value."""
    file: DataFile
    offset: int
    length: int


def _data_file_table(b: _Body, transitive: str) -> list[DataFile]:
    """A data file table: every path shares a prefix with the one before it;
    each file's base path is `transitive` (the base of the file the table
    was read from) followed by the first base_path_length bytes."""
    n = b.varint()
    if n == 0:
        return []
    prefix = [0] + b.varints(n - 1)
    suffix = b.varints(n)
    base = b.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise b.fail(f"data file {i}: prefix {prefix[i]} longer than the path before")
        path = prev[: prefix[i]] + b.take(suffix[i])
        if base[i] > len(path):
            raise b.fail(f"data file {i}: base path longer than the path")
        text = path.decode()
        files.append(DataFile(transitive + text[: base[i]], transitive + text))
        prev = path
    return files


def _file(files: list[DataFile], i: int, b: _Body) -> DataFile:
    if i >= len(files):
        raise b.fail(f"data file id {i} out of range ({len(files)} files)")
    return files[i]


def _keys(b: _Body, n: int, with_subtree: bool):
    prefix = [0] + b.varints(n - 1)
    suffix = b.varints(n)
    common = b.varints(n) if with_subtree else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise b.fail(f"key {i}: shared prefix {prefix[i]} longer than the key before")
        key = prev[: prefix[i]] + b.take(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


Value = Union[bytes, Ref]


class OcdbtReader:
    """The latest version of the OCDBT database at `root`: `list_keys()` and
    `read(key)`. The whole index is read once, at construction."""

    def __init__(self, root):
        self.root = Path(root)
        self.config, version = self._manifest()
        self._index: dict[bytes, Value] = {}
        #: The B+tree's height (0: the root is a leaf; None: no keys).
        self.height = None if version is None else version[1]
        if version is not None:
            self._walk(version[0], version[1], b"")

    # -------------------------------------------------------------- files

    def _read(self, ref: Ref) -> bytes:
        path = self.root / ref.file.path
        try:
            with open(path, "rb") as f:
                data = os.pread(f.fileno(), ref.length, ref.offset)
        except FileNotFoundError as e:
            raise ValueError(f"{path}: OCDBT: data file missing") from e
        if len(data) != ref.length:
            raise ValueError(f"{path}: OCDBT: {ref.length} bytes at {ref.offset} run past its "
                             f"end ({path.stat().st_size} bytes)")
        return data

    def _where(self, ref: Ref) -> str:
        return f"{self.root / ref.file.path}[{ref.offset}:+{ref.length}]"

    # ----------------------------------------------------------- manifest

    def _manifest(self):
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise ValueError(f"{self.root}: not an OCDBT database (no manifest.ocdbt)")
        what = str(path)
        b = _Body(unframe(path.read_bytes(), MANIFEST_MAGIC, what), what)
        config = self._config(b)
        if config["manifest_kind"] == 1:  # numbered: the versions are elsewhere
            if b.pos != len(b.data):
                raise b.fail("bytes after a numbered manifest's config")
            numbered = sorted(p.name for p in self.root.iterdir() if _NUMBERED.fullmatch(p.name))
            if not numbered:
                return config, None
            what = str(self.root / numbered[-1])
            b = _Body(unframe((self.root / numbered[-1]).read_bytes(), MANIFEST_MAGIC, what),
                      what)
            self._config(b)
        elif config["manifest_kind"] != 0:
            raise b.fail(f"unknown manifest kind {config['manifest_kind']}")
        return config, self._latest(b)

    @staticmethod
    def _config(b: _Body) -> dict:
        config = {"uuid": b.take(16).hex(), "manifest_kind": b.varint(),
                  "max_inline_value_bytes": b.varint(), "max_decoded_node_bytes": b.varint(),
                  "version_tree_arity_log2": b.u8(), "compression": b.varint()}
        if config["compression"] == 1:
            config["zstd_level"] = struct.unpack("<i", b.take(4))[0]
        elif config["compression"] != 0:
            raise b.fail(f"unknown compression method {config['compression']}")
        return config

    def _latest(self, b: _Body):
        """(root ref, height) of the newest version held inline, or None when
        it is empty. Older versions (in version tree nodes) are not read."""
        files = _data_file_table(b, "")
        n = b.varint()
        if n == 0:
            raise b.fail("a manifest with no inline version")
        generation = b.varints(n)
        height = [b.u8() for _ in range(n)]
        file_id, offset, length = b.varints(n), b.varints(n), b.varints(n)
        num_keys = b.varints(n)
        b.varints(n)  # num_tree_bytes
        b.varints(n)  # num_indirect_value_bytes
        b.take(8 * n)  # commit_time
        i = max(range(n), key=generation.__getitem__)
        if num_keys[i] == 0 or offset[i] == _MISSING:
            return None
        return Ref(_file(files, file_id[i], b), offset[i], length[i]), height[i]

    # ------------------------------------------------------------- B+tree

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = self._where(ref)
        b = _Body(unframe(self._read(ref), NODE_MAGIC, what), what)
        if b.u8() != height:
            raise b.fail(f"node height differs from its parent's record ({height})")
        files = _data_file_table(b, ref.file.base)
        n = b.varint()
        if n == 0:
            raise b.fail("empty node")
        keys, common = _keys(b, n, with_subtree=height > 0)
        if height > 0:
            ids, offsets, lengths = b.varints(n), b.varints(n), b.varints(n)
            b.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise b.fail(f"entry {i}: subtree prefix longer than its key")
                self._walk(Ref(_file(files, ids[i], b), offsets[i], lengths[i]), height - 1,
                           prefix + keys[i][: common[i]])
            return
        lengths = b.varints(n)
        kinds = b.varints(n)
        if any(k > 1 for k in kinds):
            raise b.fail(f"unknown value kind {max(kinds)}")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = b.varints(len(indirect)), b.varints(len(indirect))
        for i, fid, off in zip(indirect, ids, offsets):
            self._index[prefix + keys[i]] = Ref(_file(files, fid, b), off, lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self._index[prefix + keys[i]] = b.take(lengths[i])
        if b.pos != len(b.data):
            raise b.fail(f"{len(b.data) - b.pos} bytes after the leaf's values")

    # ---------------------------------------------------------------- API

    def list_keys(self) -> list[str]:
        return sorted(k.decode() for k in self._index)

    def read(self, key: str) -> bytes:
        """The value of `key` (KeyError when absent)."""
        value = self._index[key.encode()]
        return value if isinstance(value, bytes) else self._read(value)

    def get(self, key: str):
        """The value of `key`, or None when absent (the zarr stores' call)."""
        return self.read(key) if key.encode() in self._index else None

