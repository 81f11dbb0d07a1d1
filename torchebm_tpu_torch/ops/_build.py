"""Build, load and launch the port's CUDA kernels.

Every ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into an
object file, all sources at once in parallel processes, and the objects are
linked into one shared library with a plain C interface, at first use, under
``build/torch_kernels/`` at the root of the checkout. The library's name
carries a hash of every file under ``csrc/`` (sources and the ``*.cuh``
headers they include) and of the flags, so an edited source or header is
rebuilt and an unchanged tree is loaded as it is. The library is loaded with
:mod:`ctypes`; it links no PyTorch headers, so a build takes seconds.

:func:`launch` calls one C entry point on a device's current stream, with
the argument types its kernel module declares. :func:`counted` registers a
kernel wrapper, whose ``launches`` attribute the wrapper raises by one each
time it launches its kernel, and runs each call of it inside the span
``ops.<wrapper name>`` (:func:`~torchebm_tpu_torch.utils.profiling.span`);
:func:`launch_counts` and :func:`reset_launch_counts` read and clear every
registered wrapper's count.

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
from typing import Optional

from ..utils.profiling import span

__all__ = [
    "BUILD_DIR", "build_library", "counted", "find_nvcc", "launch", "launch_counts",
    "library_path", "load_library", "ptr", "reset_launch_counts",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH,
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    # per-kernel registers, shared memory and spills go to the build log
    "-Xptxas", "-v",
)

#: ctypes argument types, for the kernel modules' entry signatures
PTR, INT, FLOAT, U32, I64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32,
                             ctypes.c_longlong)

_COUNTED: list = []


def counted(fn):
    """Register the kernel wrapper ``fn`` with a ``launches`` count of 0; its
    calls run inside the span ``ops.<name>``."""
    name = f"ops.{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}`` over every registered wrapper."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _hashed_files() -> list:
    """Every file a build reads: the sources and the headers beside them."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


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
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"torchebm_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> list:
    """Run the commands in parallel processes; ``[(cmd, returncode, output)]``."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    results = []
    for cmd, p in procs:
        out = p.communicate()[0]
        results.append((cmd, p.returncode, out))
    return results


def build_library() -> Path:
    """Compile each source to an object in parallel, then link them into
    :func:`library_path`; the compilers' output (``-Xptxas -v`` included) is
    kept beside it with the suffix ``.log``."""
    nvcc = find_nvcc()
    path = library_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    stem = path.with_name(f"{path.name}.{os.getpid()}")
    tmp = Path(f"{stem}.tmp")
    objs = [Path(f"{stem}.{src.stem}.o") for src in _sources()]
    try:
        steps = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                          for src, obj in zip(_sources(), objs)])
        if all(rc == 0 for _, rc, _ in steps):
            steps += _run_all([[nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        for cmd, rc, out in steps:
            if rc != 0:
                raise RuntimeError(f"nvcc failed with exit code {rc}:\n{' '.join(cmd)}\n{out}")
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    path.with_suffix(".log").write_text("".join(out for _, _, out in steps))
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if it is missing."""
    path = library_path()
    if not path.exists():
        build_library()
    lib = ctypes.CDLL(str(path))
    lib.tebm_error_string.argtypes = [ctypes.c_int]
    lib.tebm_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _entry(name: str, argtypes: tuple):
    fn = getattr(load_library(), f"tebm_{name}")
    fn.argtypes = [*argtypes, PTR]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, device, *args) -> None:
    """Call C entry ``tebm_<name>``, whose arguments have the ctypes
    ``argtypes`` (every entry then takes the stream and returns
    ``cudaGetLastError()`` as an int), on ``device``'s current stream; raise
    on a non-zero return."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry(name, argtypes)(*args, stream)
    if rc != 0:
        msg = load_library().tebm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc} ({msg})")


def ptr(t) -> Optional[int]:
    """A tensor's device address for a ``c_void_p`` argument (None for None)."""
    return None if t is None else t.data_ptr()
