"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface,
under ``build/kernels/`` at the root of the checkout (a directory
``.gitignore`` lists), and loaded with ``ctypes``.  The sources compile in
parallel, one ``nvcc`` each, all started together.  A library's file name
carries a hash of its source, the shared headers and the flags, so an
edited source is rebuilt and a stale library never loads.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import types
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
SOURCES = (CSRC / "pathgen.cu", CSRC / "pathgen_tiled.cu")
HEADERS = (CSRC / "philox.cuh",)
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


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *HEADERS):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[list[Path], float]:
    """Compile every source whose library does not exist yet, all at once;
    returns (library paths, wall seconds spent compiling)."""
    libs = [library_path(src) for src in SOURCES]
    todo = [(src, lib) for src, lib in zip(SOURCES, libs) if not lib.exists()]
    if not todo:
        return libs, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc failed ({proc.returncode}):\n"
                          f"{out}")
            continue
        if verbose:
            print(f"{src.name}:\n{out}", flush=True)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load() -> types.SimpleNamespace:
    """The kernels' C entries with their signatures declared (built first
    if needed), as attributes of one namespace.  Every launching entry
    returns a cudaError_t as int."""
    paths, _ = build()
    single, tiled = (ctypes.CDLL(str(p)) for p in paths)
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
    ll = ctypes.c_longlong
    signatures = {
        (single, "mcop_pathgen"): [p, p, p, i, i, i, u, f, f, f, f, f, p, p],
        (single, "mcop_priced_chunk"): [p, p, p, i, i, i, u, f, f, f, f,
                                        p, ll, f, i, p, p],
        (tiled, "mcop_tiled_smem_bytes"): [i],
        (tiled, "mcop_tiled_pathgen"): [p, i, p, p, i, i, i, u, f, f, f, f,
                                        f, p, p],
        (tiled, "mcop_tiled_priced_chunk"): [p, i, p, p, i, i, i, u, f, f,
                                             f, f, p, ll, f, i, p, p],
    }
    entries = {}
    for (lib, name), argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
        entries[name] = fn
    return types.SimpleNamespace(**entries)
