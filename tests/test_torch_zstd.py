"""The port's zstd decoder (``sggan_tpu_torch/utils/zstd.py``, host C++
``csrc/zstd_decode.cpp``) against ``zstandard``, which serves here as the
oracle only (the port never imports it).

A corpus that exercises every block and literal kind (random bytes, f32
weights, bf16 rows, long runs, text, an empty input, a frame of several
blocks, blocks of one byte, literals that are one byte repeated, values
repeated at one offset) is compressed at levels 1,
3, 9 and 19, with and without the content checksum and the content size,
and each frame decodes byte for byte; the corpus's frames are walked to
show that they hold every kind (raw, RLE and compressed blocks; raw,
RLE, Huffman and treeless literals; one and four streams; direct and
FSE-compressed Huffman weights; predefined, RLE, FSE and repeated
sequence tables).  The chunks and nodes that Orbax writes decode as
tensorstore reads them, and a store of small B-tree nodes over more
commits than its manifest keeps inline reads as tensorstore wrote it.  A flipped byte, a truncated frame and a frame
that names a dictionary each raise, naming the input.
"""

import collections
import functools
import os

import pytest

torch = pytest.importorskip("torch")
zs = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from sggan_tpu_torch.utils import ocdbt, orbax, zstd  # noqa: E402

LEVELS = (1, 3, 9, 19)


def _corpus() -> dict:
    r = np.random.default_rng(0)
    words = [bytes(r.integers(97, 123, int(n), np.uint8))
             for n in r.integers(2, 9, 800)]
    head = r.integers(0, 256, 40000, np.uint8).tobytes()
    return {
        "random": r.integers(0, 256, 50000, np.uint8).tobytes(),
        "f32_weights": (r.standard_normal(40000) * 0.02).astype(
            np.float32).tobytes(),
        "bf16_rows": (r.standard_normal(60000).astype(np.float32).view(
            np.uint32) >> 16).astype(np.uint16).tobytes(),
        "runs": b"a" * 70000 + b"b" * 3 + b"\0" * 60000 + b"cd" * 5000,
        # whole blocks of one byte: RLE blocks
        "one_byte_blocks": b"\0" * 300000,
        # each f32 sixteen times over: one offset, RLE and repeated tables
        "repeated_f32": np.repeat(r.standard_normal(5000).astype(
            np.float32), 16).tobytes(),
        "text": b" ".join(words[i] for i in r.zipf(1.3, 30000) % 800),
        "empty": b"",
        # several 128 KiB blocks: repeats of a block earlier in the frame
        "three_blocks": np.tile(r.integers(0, 64, 50000, np.uint8), 7)
        .tobytes(),
        # matches whose literals are all one byte: RLE literals
        "one_byte_literals": head + b"".join(
            head[s:s + 100] + b"Q" for s in r.integers(0, 39000, 1500)),
    }


CORPUS = _corpus()


def kinds(data: bytes) -> collections.Counter:
    """The block kinds, literal kinds, Huffman weight forms and sequence
    table modes in the zstd frames of ``data`` (RFC 8878 section 3)."""
    c = collections.Counter()
    p = 0
    while p < len(data):
        assert data[p:p + 4] == b"\x28\xb5\x2f\xfd"
        fhd = data[p + 4]
        single = (fhd >> 5) & 1
        q = p + 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
        fcs = fhd >> 6
        q += (1 if single else 0) if fcs == 0 else 1 << fcs
        last = False
        while not last:
            bh = int.from_bytes(data[q:q + 3], "little")
            q += 3
            last, t, size = bh & 1, (bh >> 1) & 3, bh >> 3
            c["block", ("raw", "rle", "compressed")[t]] += 1
            if t == 2:
                b = data[q:q + size]
                lt, sf = b[0] & 3, (b[0] >> 2) & 3
                c["literals", ("raw", "rle", "huffman", "treeless")[lt]] += 1
                if lt >= 2:
                    hs = (3, 3, 4, 5)[sf]
                    c["streams", 1 if sf == 0 else 4] += 1
                    if lt == 2:
                        c["weights", "direct" if b[hs] >= 128 else "fse"] += 1
                    bits = (10, 10, 14, 18)[sf]
                    v = int.from_bytes(b[:hs], "little")
                    lp = hs + ((v >> (4 + bits)) & ((1 << bits) - 1))
                else:
                    hs = (1, 2, 1, 3)[sf]
                    v = int.from_bytes(b[:hs], "little")
                    n = v >> (3 if hs == 1 else 4)
                    lp = hs + (n if lt == 0 else 1)
                b0 = b[lp]
                if b0:
                    m = b[lp + (1 if b0 < 128 else 2 if b0 < 255 else 3)]
                    for name, sh in (("LL", 6), ("OF", 4), ("ML", 2)):
                        c["table", name, ("predefined", "rle", "fse",
                                          "repeat")[(m >> sh) & 3]] += 1
            q += 1 if t == 1 else size
        if (fhd >> 2) & 1:
            c["checksum"] += 1
            q += 4
        c["frame"] += 1
        p = q
    return c


@functools.cache
def _frame(data: bytes, level: int, checksum=False, size=True) -> bytes:
    return zs.ZstdCompressor(level=level, write_checksum=checksum,
                             write_content_size=size).compress(data)


@pytest.mark.parametrize("level", LEVELS)
def test_corpus_decodes_byte_for_byte(level):
    for name, data in CORPUS.items():
        outs = []
        for checksum in (False, True):
            for size in (False, True):
                frame = _frame(data, level, checksum, size)
                outs.append(zstd.decompress(frame, name).tobytes())
                assert outs[-1] == data, (name, level, checksum, size)
        assert outs[0] == outs[-1]
    # frames one after another, a skippable frame between them
    both = (_frame(CORPUS["text"], level) + b"\x50\x2a\x4d\x18"
            + (3).to_bytes(4, "little") + b"xyz"
            + _frame(CORPUS["f32_weights"], level, checksum=True))
    assert zstd.decompress(both).tobytes() == (CORPUS["text"]
                                               + CORPUS["f32_weights"])


def test_corpus_holds_every_kind():
    c = collections.Counter()
    for level in LEVELS:
        for data in CORPUS.values():
            c += kinds(_frame(data, level, checksum=True))
    want = [("block", k) for k in ("raw", "rle", "compressed")] + \
        [("literals", k) for k in ("raw", "rle", "huffman", "treeless")] + \
        [("streams", 1), ("streams", 4), ("weights", "direct"),
         ("weights", "fse")] + \
        [("table", t, m) for t in ("LL", "OF", "ML")
         for m in ("predefined", "rle", "fse", "repeat")]
    missing = [k for k in want if not c[k]]
    assert not missing, (missing, c)
    assert c["checksum"] == c["frame"]


def _orbax_item(path):
    """A tree saved by orbax: a sharded f32 array (several chunks), a bf16
    vector, a 0-d count and weights of the nets' sizes."""
    r = np.random.default_rng(1)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    pool = jax.device_put(r.standard_normal((4, 16, 32, 3), np.float32),
                          NamedSharding(mesh, P("data")))
    tree = {"pool": pool, "count": jnp.int32(5),
            "w": r.standard_normal((3, 3, 16, 16)).astype(np.float32),
            "b": jnp.asarray(r.standard_normal(40), jnp.bfloat16)}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree)
    ckptr.wait_until_finished()
    return tree


def test_orbax_chunks_against_tensorstore(tmp_path):

    path = str(tmp_path / "cp-0001")
    tree = _orbax_item(path)
    db = ocdbt.Database(path)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    keys = [k.decode() for k in kv.list().result()]
    assert db.keys() == sorted(keys)
    chunks = [k for k in keys if not k.endswith(".zarray")]
    assert len([k for k in chunks if k.startswith("pool/")]) == 2
    for k in keys:
        raw = db.get(k)
        assert raw == kv.read(k).result().value, k
        if k in chunks:
            assert zstd.decompress(raw, k).tobytes() == \
                zs.ZstdDecompressor().decompressobj().decompress(raw), k
    for name in tree:
        arr = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{path}/"},
            "path": name}).result().read().result()
        got = orbax.read_array(db, name, path)
        if arr.dtype.name == "bfloat16":
            assert got.dtype == orbax.BF16_BITS
            got, arr = got.view(np.uint16), arr.view(np.uint16)
        assert got.shape == arr.shape and got.tobytes() == arr.tobytes()
    # a store of small nodes and more commits than a manifest keeps
    # inline: interior B-tree nodes, keys without their parents' common
    # prefix, values in data files, references to a version node
    small = tmp_path / "small"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{small}/",
                          "config": {"max_decoded_node_bytes": 200,
                                     "max_inline_value_bytes": 8}}).result()
    for i in range(20):
        kv.write(f"k{i:03d}".encode(), b"v" * i).result()
    db = ocdbt.Database(str(small))
    assert db.version.height > 0 and db.version.generation > 16
    assert db.keys() == [f"k{i:03d}" for i in range(20)]
    assert all(db.get(f"k{i:03d}") == b"v" * i for i in range(20))


def _corrupt(kind: str) -> bytes:
    frame = bytearray(_frame(CORPUS["f32_weights"], 3, checksum=True))
    if kind == "flip":  # a byte of a raw block: only the checksum sees it
        frame = bytearray(_frame(CORPUS["random"], 3, checksum=True))
        assert kinds(bytes(frame))["block", "raw"]
        frame[len(frame) // 2] ^= 0x10
    elif kind == "truncate":
        frame = frame[:len(frame) - 100]
    else:  # a one-byte Dictionary_ID (7) in the frame header
        frame = bytearray(_frame(b"abc" * 100, 3))
        single = (frame[4] >> 5) & 1
        frame[4] |= 1
        frame.insert(5 if single else 6, 7)
    return bytes(frame)


@pytest.mark.parametrize("kind, reason", (
    ("flip", "content checksum mismatch"), ("truncate", "truncated"),
    ("dictionary", "dictionary 7")))
def test_corrupt_frame_raises_naming_it(kind, reason):
    with pytest.raises(ValueError, match=f"chunk 7/0.0: .*{reason}"):
        zstd.decompress(_corrupt(kind), "chunk 7/0.0")


def test_checksums_and_a_corrupt_node(tmp_path):
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    frame = _frame(CORPUS["runs"], 1, checksum=True)
    assert zstd.xxh64(CORPUS["runs"]) & 0xFFFFFFFF == \
        int.from_bytes(frame[-4:], "little")
    assert zstd.crc32c(b"123456789") == 0xE3069283
    path = str(tmp_path / "cp-0002")
    _orbax_item(path)
    assert ocdbt.Database(path).keys()
    manifest = os.path.join(path, "manifest.ocdbt")
    with open(manifest, "r+b") as f:
        raw = bytearray(f.read())
        raw[20] ^= 1
        f.seek(0)
        f.write(raw)
    with pytest.raises(ValueError, match="manifest.ocdbt: CRC-32C"):
        ocdbt.Database(path)
