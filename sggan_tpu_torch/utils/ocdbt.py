"""A reader of one OCDBT database, the key-value store under each of the
JAX package's Orbax checkpoints (``utils/orbax.py``), in numpy and the
port's zstd decoder (``utils/zstd.py``), without tensorstore.

The format is tensorstore's "Optionally-Cooperative Distributed B+Tree"
as this repo's orbax (0.11) writes it:

- ``manifest.ocdbt``: magic ``0cdb3a2a``, the file's length, format
  version 0, a compression tag (0 none, 1 zstd) and the body, then a
  CRC-32C of all before it.  The body holds the config (uuid, manifest
  kind, inline and node limits, the version tree's arity, the
  compression), a table of data files, and the version tree: its newest
  versions inline (generation, root height, the root node's reference and
  statistics, commit time) and references to version nodes with the
  older ones.
- B-tree nodes in data files under ``d/``: magic ``0cdb20de``, the same
  header, checksum and compression.  A node has its height, its own data
  file table and its entries, keys prefix-compressed against the entry
  before.  A leaf entry has its value inline or as a reference (file,
  offset, length) to bytes in a data file; an interior entry refers to a
  child node and gives the length of the key prefix that all keys under
  it share, which the child's keys leave out.
- A data file table lists each file's path relative to the database's
  directory, prefix-compressed, with the length of its base.  Orbax's
  root database refers, through such paths, to the nodes and values that
  each process wrote under ``ocdbt.process_N/``, so a checkpoint that
  several processes saved reads whole from the root.

Only the newest version is read.  A checksum that does not match, an
unknown format version, compression, manifest kind or node height, or a
reference past the end of a file raises ``ValueError`` with the file's
path.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Optional

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # the offset of an empty tree's root reference


class _Cursor:
    """Reads the body's fields in order; a read past its end raises."""

    def __init__(self, data: bytes, where: str):
        self.b = data
        self.i = 0
        self.where = where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what}")

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            self.fail("truncated")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            c = self.byte()
            out |= (c & 0x7F) << shift
            if not c & 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def bytes_list(self, n: int) -> List[int]:
        return list(self.take(n))


class Ref(NamedTuple):
    """A span of a data file: its path under the database, offset, length."""
    path: str
    offset: int
    length: int


def _body(raw: bytes, magic: int, where: str) -> bytes:
    """The body of a manifest or node after its header and checksum have
    been checked, decompressed."""
    if len(raw) < 18:
        raise ValueError(f"{where}: {len(raw)} bytes, too short")
    got_magic, length = struct.unpack(">I", raw[:4])[0], \
        struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{where}: magic {got_magic:08x}, "
                         f"expected {magic:08x}")
    if length != len(raw):
        raise ValueError(f"{where}: header says {length} bytes, "
                         f"{len(raw)} read")
    crc = struct.unpack("<I", raw[-4:])[0]
    if zstd.crc32c(raw[:-4]) != crc:
        raise ValueError(f"{where}: CRC-32C mismatch")
    c = _Cursor(raw[:-4], where)
    c.i = 12
    version = c.varint()
    if version != 0:
        raise ValueError(f"{where}: OCDBT format version {version}; "
                         "only version 0 is read")
    comp = c.varint()
    if comp == 0:
        return raw[c.i:-4]
    if comp == 1:
        return zstd.decompress(raw[c.i:-4], where).tobytes()
    raise ValueError(f"{where}: compression {comp}; only none (0) and "
                     "zstd (1) are read")


def _data_files(c: _Cursor) -> List[str]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            c.fail(f"data file {i}: prefix longer than the path before")
        path = prev[:prefix[i]] + c.take(suffix[i])
        if base[i] > len(path):
            c.fail(f"data file {i}: base longer than its path")
        out.append(path.decode())
        prev = path
    return out


def _ref(c: _Cursor, files: List[str], fid: int, offset: int,
         length: int) -> Ref:
    if fid >= len(files):
        c.fail(f"data file id {fid} of {len(files)}")
    return Ref(files[fid], offset, length)


class Version(NamedTuple):
    generation: int
    height: int
    root: Optional[Ref]  # None: an empty tree
    num_keys: int


class Database:
    """The newest version of the OCDBT database in directory ``path``.

    ``keys()`` lists its keys in order; ``get(key)`` returns a key's value
    as bytes, or None where there is none.  Node and value files are
    read when needed; the keys and their value references are read once.
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.version = self._manifest()
        self._entries: Optional[Dict[bytes, object]] = None

    def _file(self, rel: str) -> str:
        return os.path.join(self.path, rel)

    def _read(self, ref: Ref) -> bytes:
        where = self._file(ref.path)
        try:
            with open(where, "rb") as f:
                f.seek(ref.offset)
                data = f.read(ref.length)
        except OSError as e:
            raise ValueError(f"{where}: {e}") from e
        if len(data) != ref.length:
            raise ValueError(f"{where}: {ref.length} bytes at {ref.offset} "
                             f"referenced, {len(data)} there")
        return data

    def _manifest(self) -> Version:
        where = self._file("manifest.ocdbt")
        try:
            with open(where, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise ValueError(f"{where}: {e}") from e
        c = _Cursor(_body(raw, MANIFEST_MAGIC, where), where)
        c.take(16)  # uuid
        kind = c.varint()
        if kind != 0:
            c.fail(f"manifest kind {kind}; only a single manifest (0) is "
                   "read")
        c.varint()  # max_inline_value_bytes
        c.varint()  # max_decoded_node_bytes
        c.byte()    # version_tree_arity_log2
        comp = c.varint()
        if comp == 1:
            c.u32()  # the zstd level
        elif comp != 0:
            c.fail(f"config compression {comp}")
        files = _data_files(c)
        n = c.varint()
        gens, heights = c.varints(n), c.bytes_list(n)
        fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
        nkeys = c.varints(n)
        c.varints(n)  # num_tree_bytes
        c.varints(n)  # num_indirect_value_bytes
        [c.u64() for _ in range(n)]  # commit times
        # references to version nodes that hold the older versions
        m = c.varint()
        for _ in range(5):  # generation, file, offset, length, generations
            c.varints(m)
        [c.u64() for _ in range(m)]  # commit times
        c.bytes_list(m)  # heights
        if c.i != len(c.b):
            c.fail(f"{len(c.b) - c.i} bytes after the version tree")
        if n == 0:
            c.fail("no version inline")
        i = max(range(n), key=gens.__getitem__)
        root = None if offs[i] == MISSING else \
            _ref(c, files, fids[i], offs[i], lens[i])
        return Version(gens[i], heights[i], root, nkeys[i])

    def _node(self, ref: Ref, prefix: bytes, height: int,
              out: Dict[bytes, object]) -> None:
        where = f"{self._file(ref.path)}@{ref.offset}"
        c = _Cursor(_body(self._read(ref), NODE_MAGIC, where), where)
        got = c.byte()
        if got != height:
            c.fail(f"node of height {got} where {height} was expected")
        files = _data_files(c)
        n = c.varint()
        if n == 0:
            c.fail("node without entries")
        pre = [0] + c.varints(n - 1)
        suf = c.varints(n)
        common = c.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if pre[i] > len(prev):
                c.fail(f"entry {i}: key prefix longer than the key before")
            prev = prev[:pre[i]] + c.take(suf[i])
            keys.append(prev)
        if height:
            fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            for _ in range(3):  # num_keys, tree bytes, indirect bytes
                c.varints(n)
            if c.i != len(c.b):
                c.fail(f"{len(c.b) - c.i} bytes after the entries")
            for i, k in enumerate(keys):
                if common[i] > len(k):
                    c.fail(f"entry {i}: common prefix longer than its key")
                self._node(_ref(c, files, fids[i], offs[i], lens[i]),
                           prefix + k[:common[i]], height - 1, out)
            return
        lens = c.varints(n)
        kinds = c.varints(n)
        ind = [i for i, k in enumerate(kinds) if k == 1]
        if any(k > 1 for k in kinds):
            c.fail(f"value kind {max(kinds)}; 0 (inline) and 1 "
                   "(indirect) are read")
        fids, offs = c.varints(len(ind)), c.varints(len(ind))
        refs = {i: _ref(c, files, f, o, lens[i])
                for i, f, o in zip(ind, fids, offs)}
        for i, k in enumerate(keys):
            out[prefix + k] = refs[i] if i in refs else c.take(lens[i])
        if c.i != len(c.b):
            c.fail(f"{len(c.b) - c.i} bytes after the values")

    def _all(self) -> Dict[bytes, object]:
        if self._entries is None:
            out: Dict[bytes, object] = {}
            if self.version.root is not None:
                self._node(self.version.root, b"", self.version.height, out)
            if len(out) != self.version.num_keys:
                raise ValueError(f"{self.path}: {len(out)} keys in the tree, "
                                 f"the manifest says {self.version.num_keys}")
            self._entries = out
        return self._entries

    def keys(self) -> List[str]:
        return [k.decode() for k in sorted(self._all())]

    def get(self, key: str) -> Optional[bytes]:
        v = self._all().get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        return self._read(v)
