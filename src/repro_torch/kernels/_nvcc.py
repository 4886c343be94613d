"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled at first use
into ``build/repro_torch/<name>-<hash>.so`` under the repository root (a
git-ignored directory), keyed by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  This is
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
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
