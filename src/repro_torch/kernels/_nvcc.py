"""Build the port's CUDA sources with nvcc, load them with ctypes, and the
launch plumbing every kernel wrapper (``kernels/*/kernel.py``) shares.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled at first use
into ``build/repro_torch/<name>-<hash>.so`` under the repository root (a
git-ignored directory), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.  This is
the ``nvcc`` + ``ctypes`` route: seconds per build, where a source that
includes PyTorch's headers takes minutes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # the `dtype` argument of every launch
MAX_GRID_YZ = 65535  # CUDA's limit on a grid's y and z extents
MAX_D = 2048  # neighbour slots per row: the kernels compact them in shared memory


def sources() -> tuple:
    """Every CUDA source of the port, by name."""
    return tuple(sorted(p.name for p in CSRC.glob("*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the port's "
                       "kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / name
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every source not yet built, one nvcc process each, all
    started together.  Each build's compiler output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside it as ``.log``.
    Raises with the compiler's errors if any build fails."""
    libs = {name: library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, lib in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            lib = todo[name]
            lib.with_suffix(".log").write_text(log)
            if proc.returncode:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>``, building it first if needed."""
    return ctypes.CDLL(str(build_all([name])[name]))


@functools.lru_cache(maxsize=None)
def bind(source: str, name: str, n_ptrs: int, n_ints: int, n_floats: int = 0) -> ctypes.CDLL:
    """The library of ``csrc/<source>`` with the C signatures of
    ``<name>_launch(n_ptrs pointers, n_ints ints, n_floats floats, stream)``,
    which returns a CUDA error code, and ``<name>_error_string(code)`` set."""
    lib = load(source)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def check_cuda(wrapper: str, plain: str, device, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on ``device``;
    ``plain`` names the plain version that CPU tensors take."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{wrapper} takes CUDA tensors; {name} is on {t.device} "
                             f"(use {plain} there)")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(lib: ctypes.CDLL, name: str, device, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on ``device``'s current stream
    (no synchronisation); raise with the CUDA error it returns, if any."""
    with torch.cuda.device(device):
        rc = getattr(lib, f"{name}_launch")(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
