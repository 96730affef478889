"""A reader of one item of the JAX package's Orbax checkpoints (a
``cp-NNNN`` directory that ``sggan_tpu/utils/checkpoint.py::save`` writes
with ``orbax.checkpoint.StandardCheckpointer``), in numpy, without JAX,
orbax, tensorstore, zstandard or ml_dtypes.

An item directory holds ``_METADATA`` (JSON: each leaf's key path, with
each key's type, and its value type) and an OCDBT database
(``utils/ocdbt.py``) whose keys are zarr v2 arrays, one a leaf, named by
the leaf's keys joined with ".": ``<name>/.zarray`` (JSON: shape, chunks,
dtype, compressor, fill value, order) and one key a chunk,
``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d leaf), each chunk one zstd
frame of the chunk's full shape in C order.  A sharded array is saved as
several chunks; a missing chunk is the fill value's.

``read(path)`` returns the item's tree as nested dicts (a node whose keys
are sequence indices as a list) of numpy arrays; an empty container that
Orbax records without data (the IN nets' ``bn: {}``) comes back empty.
The zarr dtype ``"bfloat16"`` comes back as ``BF16_BITS``, a structured
dtype over its ``uint16`` bits that torch refuses as it stands: the
caller makes it ``torch.bfloat16`` by a view of those bits
(``bridge.tensor_from_numpy``).  A checkpoint
written with zarr3, without OCDBT, in another order or with a codec
other than zstd or none is refused by name.
"""

from __future__ import annotations

import ast
import hashlib
import itertools
import json
import math
import os
from typing import Any, Dict

import numpy as np

from . import zstd
from .ocdbt import Database

KEY_SEQUENCE, KEY_DICT = 1, 2  # orbax's KeyType
BF16_BITS = np.dtype([("bfloat16", "<u2")])
_EMPTY = {"Dict": dict, "List": list, "None": lambda: None}


def _dtype(s: str, where: str) -> np.dtype:
    if s == "bfloat16":
        return BF16_BITS
    try:
        dt = np.dtype(s)
    except TypeError as e:
        raise ValueError(f"{where}: zarr dtype {s!r} is not read") from e
    if dt.kind not in "biuf":
        raise ValueError(f"{where}: zarr dtype {s!r} is not read")
    return dt


def read_array(db: Database, name: str, where: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``db``, assembled from its chunks."""
    raw = db.get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"{where}: no array {name!r} in the store")
    z = json.loads(raw)
    if z.get("zarr_format") != 2:
        raise ValueError(f"{where}: {name}: zarr_format "
                         f"{z.get('zarr_format')}; only 2 is read")
    if z.get("order", "C") != "C" or z.get("filters"):
        raise ValueError(f"{where}: {name}: order {z.get('order')!r}, "
                         f"filters {z.get('filters')!r}; C order without "
                         "filters is read")
    comp = z.get("compressor")
    codec = None if comp is None else comp.get("id")
    if codec not in (None, "zstd"):
        raise ValueError(f"{where}: {name}: codec {codec!r}; only zstd and "
                         "none are read")
    dt = _dtype(z["dtype"], f"{where}: {name}")
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    if len(shape) != len(chunks):
        raise ValueError(f"{where}: {name}: shape {shape}, chunks {chunks}")
    sep = z.get("dimension_separator", ".")
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    nbytes = math.prod(chunks) * dt.itemsize
    fill = z.get("fill_value")
    out = None
    for idx in itertools.product(*map(range, grid)):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = db.get(key)
        if data is None:
            continue
        block = zstd.decompress(data, f"{where}: {key}", nbytes) \
            if codec else np.frombuffer(data, np.uint8)
        if block.size != nbytes:
            raise ValueError(f"{where}: {key}: {block.size} bytes, the "
                             f"chunk {chunks} of {dt} is {nbytes}")
        block = block.view(dt).reshape(chunks)
        if chunks == shape:  # one chunk: the array itself, no copy
            return block
        if out is None:
            out = _filled(shape, dt, fill)
        at = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[at] = block[tuple(slice(0, a.stop - a.start) for a in at)]
    return out if out is not None else _filled(shape, dt, fill)


def _filled(shape, dt: np.dtype, fill) -> np.ndarray:
    out = np.zeros(shape, dt)
    if fill is not None:
        if dt == BF16_BITS:
            raise ValueError(f"bfloat16 fill value {fill!r} is not read")
        out[...] = fill
    return out


def _keys(entry: dict, where: str):
    out = []
    for k in entry["key_metadata"]:
        t = k.get("key_type")
        if t == KEY_DICT:
            out.append((str(k["key"]), False))
        elif t == KEY_SEQUENCE:
            out.append((int(k["key"]), True))
        else:
            raise ValueError(f"{where}: key type {t!r} of {k['key']!r}")
    return out


def _as_lists(node):
    if isinstance(node, _Seq):
        return [_as_lists(node[i]) for i in sorted(node)]
    if isinstance(node, dict):
        return {k: _as_lists(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A node built from sequence keys, made a list at the end."""


def read(path: str) -> Dict[str, Any]:
    """The tree of the Orbax item in directory ``path``."""
    path = os.path.abspath(path)
    where = os.path.join(path, "_METADATA")
    try:
        with open(where) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"{where}: {e}") from e
    if meta.get("use_zarr3"):
        raise ValueError(f"{where}: use_zarr3 is true; only zarr v2 "
                         "checkpoints are read")
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{where}: use_ocdbt is false; only OCDBT "
                         "checkpoints are read")
    db = Database(path)
    tree: dict = {}
    for key_str, entry in meta["tree_metadata"].items():
        keys = _keys(entry, where)
        if not keys:
            raise ValueError(f"{where}: a leaf with no key ({key_str})")
        vm = entry["value_metadata"]
        vt = vm.get("value_type")
        if vm.get("skip_deserialize"):
            if vt not in _EMPTY:
                raise ValueError(f"{where}: {key_str}: value type {vt!r} "
                                 "without data")
            value = _EMPTY[vt]()
        elif vt in ("jax.Array", "np.ndarray", "scalar"):
            value = read_array(db, ".".join(str(k) for k, _ in keys), path)
        else:
            raise ValueError(f"{where}: {key_str}: value type {vt!r} is "
                             "not read")
        node = tree
        for (k, _), (_, seq) in zip(keys[:-1], keys[1:]):
            node = node.setdefault(k, _Seq() if seq else {})
        node[keys[-1][0]] = value
        if tuple(k for k, _ in keys) != ast.literal_eval(key_str):
            raise ValueError(f"{where}: {key_str} against its key metadata")
    return _as_lists(tree)


def leaf_digests(tree, prefix: str = "") -> Dict[str, str]:
    """{"a/b/c": SHA-256 of the leaf's dtype, shape and bytes} of a tree of
    nested dicts and arrays (None: no leaves), the record of a state that
    the committed fixtures keep (``tests/make_orbax_fixtures.py``)."""
    out: Dict[str, str] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(leaf_digests(tree[k], f"{prefix}{k}/"))
        return out
    a = np.ascontiguousarray(np.asarray(tree))
    h = hashlib.sha256(f"{a.dtype.str} {a.shape} ".encode())
    h.update(a.tobytes())
    out[prefix[:-1]] = h.hexdigest()
    return out
