"""Build a kernel source from ``csrc/`` with nvcc at first use and load it.

The shared library has a plain C interface, bound with ``ctypes`` by the
wrapper; it does not include PyTorch's headers, so it builds in seconds.
It goes into ``sggan_tpu_torch/_build/`` (ignored by git), named by a
hash of the source and the flags, so an edited source builds anew.
``build_host`` builds host C++ the same way with ``g++`` (``$CXX``): the
dense CRF's permutohedral lattice from ``native/crf/`` (``metrics/crf.py``),
whose tracked directory it only reads, and the zstd decoder
``csrc/zstd_decode.cpp`` (``utils/zstd.py``).
Nothing here runs at import: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built from csrc/ at first use")


def _compile(name: str, files: Sequence[Path], compiler: str,
             flags: Sequence[str]) -> Tuple[Path, str, bool]:
    """``compiler flags -o lib<name>-<hash>.so <sources>`` unless that
    library exists (the hash is of ``files``, the sources and headers, and
    the flags); returns the library's path, the compiler's output (kept
    beside the library, so a later call returns it too) and whether this
    call compiled it.  A failed build raises with the compiler's output."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(f.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else "", False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    tmp_log = tmp + ".log"
    srcs = [str(f) for f in files if f.suffix in (".cu", ".cpp")]
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, *srcs],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{compiler} failed on {' '.join(srcs)}:\n"
                               f"{proc.stdout}{proc.stderr}")
        # the log before the library, each atomic: a concurrent loader sees
        # all of a file or none
        Path(tmp_log).write_text(proc.stdout + proc.stderr)
        os.replace(tmp_log, log)
        os.replace(tmp, lib)
    finally:
        for t in (tmp, tmp_log):
            if os.path.exists(t):
                os.unlink(t)
    return lib, proc.stdout + proc.stderr, True


def build(name: str) -> Tuple[Path, str, bool]:
    """Compile ``csrc/<name>.cu`` with nvcc unless its library exists (see
    ``_compile``); the output is nvcc's ptxas register and spill
    report."""
    return _compile(name, [CSRC / f"{name}.cu"], _nvcc(), NVCC_FLAGS)


def build_host(name: str, files: Sequence[Path]) -> Tuple[Path, str, bool]:
    """Compile the host C++ sources among ``files`` (headers hashed too)
    into one shared library with ``$CXX`` (default ``g++``), as
    ``native/crf/Makefile`` does, unless it exists (see ``_compile``)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (PATH, $CXX): the host libraries "
                           "(the native CRF, the zstd decoder) are built "
                           "at first use")
    return _compile(name, files, cxx, CXX_FLAGS)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)[0]))
