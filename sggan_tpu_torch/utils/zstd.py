"""Zstandard decompression for the Orbax reader (``utils/ocdbt.py``,
``utils/orbax.py``): the host C++ decoder ``csrc/zstd_decode.cpp``,
built with ``g++`` into ``sggan_tpu_torch/_build/`` at first use
(``ops/_build.py::build_host``) and bound with ``ctypes``.

``decompress(data, name)`` decodes every frame of ``data`` (RFC 8878; no
dictionary) into one numpy ``uint8`` array.  Its length is ``size`` where
the caller knows it (a zarr chunk's bytes; a frame that decodes to
another length is an error), else the frames' content sizes, or the
bytes their blocks decode to where a header has none.  A malformed,
truncated or corrupt frame raises ``ValueError`` naming ``name`` and the
reason; nothing falls back to another decoder.

``crc32c`` is the checksum of OCDBT's manifests and nodes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

SOURCE = "zstd_decode.cpp"
_ERR = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..ops._build import CSRC, build_host
    lib = ctypes.CDLL(str(build_host("sgzstd", [CSRC / SOURCE])[0]))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.sg_zstd_bound.restype = ctypes.c_int
    lib.sg_zstd_bound.argtypes = [ctypes.c_void_p, ctypes.c_size_t, u64p,
                                  ctypes.c_char_p, ctypes.c_size_t]
    lib.sg_zstd_decompress.restype = ctypes.c_int
    lib.sg_zstd_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        u64p, ctypes.c_char_p, ctypes.c_size_t]
    lib.sg_xxh64.restype = ctypes.c_uint64
    lib.sg_xxh64.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.sg_crc32c.restype = ctypes.c_uint32
    lib.sg_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    return lib


def build() -> None:
    """Build (or find) the decoder's library now."""
    _lib()


def _buffer(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data.view(np.uint8).reshape(-1))


def decompress(data, name: str = "<buffer>",
               size: Optional[int] = None) -> np.ndarray:
    """The bytes of every zstd frame in ``data`` (bytes, a buffer or a
    numpy array), as a ``uint8`` array; ``size``, where given, is the
    length they must decode to."""
    lib = _lib()
    src = _buffer(data)
    err = ctypes.create_string_buffer(_ERR)
    if size is None:
        bound = ctypes.c_uint64()
        if lib.sg_zstd_bound(src.ctypes.data, src.size, ctypes.byref(bound),
                             err, _ERR):
            raise ValueError(f"{name}: {err.value.decode()}")
        cap = bound.value
    else:
        cap = int(size)
    out = np.empty(cap, np.uint8)
    got = ctypes.c_uint64()
    if lib.sg_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                              cap, ctypes.byref(got), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    if size is not None and got.value != size:
        raise ValueError(f"{name}: {got.value} bytes decoded, {size} "
                         "expected")
    return out[:got.value]


def xxh64(data) -> int:
    src = _buffer(data)
    return int(_lib().sg_xxh64(src.ctypes.data, src.size))


def crc32c(data) -> int:
    src = _buffer(data)
    return int(_lib().sg_crc32c(src.ctypes.data, src.size))
