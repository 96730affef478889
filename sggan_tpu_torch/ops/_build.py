"""Build a kernel source from ``csrc/`` with nvcc at first use and load it.

The shared library has a plain C interface, bound with ``ctypes`` by the
wrapper; it does not include PyTorch's headers, so it builds in seconds.
It goes into ``sggan_tpu_torch/_build/`` (ignored by git), named by a
hash of the source and the flags, so an edited source builds anew.
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
from typing import Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built from csrc/ at first use")


def build(name: str) -> Tuple[Path, str, bool]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path, nvcc's output (ptxas register and spill report, kept
    beside the library, so a later call returns it too) and whether this
    call compiled it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else "", False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    tmp_log = tmp + ".log"
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
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


@functools.cache
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)[0]))
