"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout (a directory ``.gitignore`` lists), and loaded with
``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library never loads.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCES = (PACKAGE_DIR / "csrc" / "pathgen.cu",)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put it on "
                            "PATH); the port's kernels are built from "
                            "source at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmcop_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the sources unless the library for them exists; returns
    (library path, seconds spent compiling)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, lib)
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built first if
    needed).  Every entry returns a cudaError_t as int."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
    lib.mcop_pathgen.argtypes = [p, p, p, i, i, i, u, f, f, f, f, f, p, p]
    lib.mcop_pathgen.restype = i
    lib.mcop_priced_chunk.argtypes = [p, p, p, i, i, i, u, f, f, f, f,
                                      p, ctypes.c_longlong, f, i, p, p]
    lib.mcop_priced_chunk.restype = i
    return lib
