"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/lib<name>-<hash>.so`` beside this file (``.gitignore`` lists the
directory).  The hash covers the source and the flags, so an edited source
builds anew.  Nothing here runs at import: the CPU tests import every module
on a machine with no ``nvcc``.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the path.

    ptxas's report (registers, shared memory, spills per kernel) is kept
    beside the library as ``.log``.  Raises with nvcc's output on failure."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(
                f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load, ``csrc/<name>.cu`` (once per process)."""
    return ctypes.CDLL(str(build(name)))
