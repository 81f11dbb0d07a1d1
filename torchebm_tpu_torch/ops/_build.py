"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, under
``build/torch_kernels/`` at the root of the checkout. The library's name
carries a hash of the sources and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. The library is loaded with
:mod:`ctypes`; it links no PyTorch headers, so a build takes seconds.

A missing ``nvcc`` or a failed build raises :class:`RuntimeError` with the
compiler's output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "build_library", "find_nvcc", "library_path", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # per-kernel registers, shared memory and spills go to the build log
    "-Xptxas", "-v",
)


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``). Raises :class:`RuntimeError` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "torchebm_tpu_torch.ops are built at first use on a machine with the CUDA "
        "toolkit and a Hopper GPU"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"torchebm_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the sources into :func:`library_path`; the compiler's output
    (``-Xptxas -v`` included) is kept beside it with the suffix ``.log``."""
    nvcc = find_nvcc()
    path = library_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if it is missing."""
    path = library_path()
    if not path.exists():
        build_library()
    return ctypes.CDLL(str(path))
