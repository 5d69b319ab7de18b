"""Build and load the port's CUDA kernels.

Each build unit (``UNITS``: a ``csrc/*.cu`` source and its defines) is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
of its own with a plain C interface, under ``build/kernels/`` at the root
of the checkout (a directory ``.gitignore`` lists; the environment
variable ``MCOP_KERNEL_CACHE_DIR`` moves it, ``utils.jit_cache``), and
loaded with ``ctypes``.  The units compile in parallel, one ``nvcc``
each, all started together, so the build's wall is its slowest unit's:
every kernel source but P1's builds its bf16 bodies apart from the
float32 ones, and K1/K2's and K6/K7's seeded bodies apart from their
noise-in ones (``csrc/build_unit.cuh``; a unit's entries carry the
suffix of what it holds, ``entry`` picks one).  A library's file name carries a hash of its
source, the shared headers, the flags and the defines, so an edited
source is rebuilt and a stale library never loads.  Nothing here runs at
import time.
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
# The units a source splits into: (extra nvcc flags, the suffix of the
# unit's library and entry names), csrc/build_unit.cuh.
_BF16, _SEEDED, _NOISE_IN = ("-DMCOP_UNIT_BF16=1", "-DMCOP_UNIT_SEEDED=1",
                             "-DMCOP_UNIT_SEEDED=0")
_WHOLE = (((), ""),)
_BY_DTYPE = (((), ""), ((_BF16,), "_bf16"))
_BY_DTYPE_AND_SEEDED = (((_NOISE_IN,), ""), ((_SEEDED,), "_seeded"),
                        ((_BF16, _NOISE_IN), "_bf16"),
                        ((_BF16, _SEEDED), "_bf16_seeded"))
SPLITS = {"pathgen": _BY_DTYPE_AND_SEEDED,
          "pathgen_tiled": _BY_DTYPE_AND_SEEDED, "chain": _BY_DTYPE,
          "greeks": _BY_DTYPE, "pathgen_factored": _BY_DTYPE,
          "roofline": _WHOLE}
# (library name, source, extra nvcc flags, entry-name suffix) of each unit.
UNITS = tuple((stem + suffix, CSRC / f"{stem}.cu", flags, suffix)
              for stem, units in SPLITS.items() for flags, suffix in units)
HEADERS = (CSRC / "philox.cuh", CSRC / "fgn_tile.cuh",
           CSRC / "quad_policy.cuh", CSRC / "mma_bf16.cuh",
           CSRC / "slab_tile.cuh", CSRC / "build_unit.cuh",
           CSRC / "strip_sweep.cuh")
DEFAULT_BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
CACHE_ENV = "MCOP_KERNEL_CACHE_DIR"
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


def build_dir() -> Path:
    """Where the libraries are built and found: ``$MCOP_KERNEL_CACHE_DIR``,
    else ``DEFAULT_BUILD_DIR``."""
    return Path(os.environ.get(CACHE_ENV) or DEFAULT_BUILD_DIR)


def library_path(name: str, src: Path, flags: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *flags)).encode())
    for f in (src, *HEADERS):
        h.update(f.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False,
          units: tuple = UNITS) -> tuple[list[Path], float, dict]:
    """Compile every unit (of ``units``, UNITS' layout) whose library does
    not exist yet, all at once; returns (library paths in their order,
    wall seconds spent compiling, {unit name: seconds from the common start
    to its nvcc's exit})."""
    libs = [library_path(*unit[:3]) for unit in units]
    todo = [(unit, lib) for unit, lib in zip(units, libs) if not lib.exists()]
    if not todo:
        return libs, 0.0, {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for (name, src, flags, _), lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = lib.with_suffix(f".{os.getpid()}.log")
        cmd = [nvcc, *NVCC_FLAGS, *flags,
               *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp),
               str(src)]
        with open(log, "w") as out:   # a file, not a pipe: nothing blocks
            procs.append((name, lib, tmp, log, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT)))
    seconds = {}
    while len(seconds) < len(procs):
        for name, _, _, _, proc in procs:
            if name not in seconds and proc.poll() is not None:
                seconds[name] = round(time.perf_counter() - t0, 3)
        time.sleep(0.05)
    failed = []
    for name, lib, tmp, log, proc in procs:
        out = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n"
                          f"{out}")
            continue
        if verbose:
            print(f"{name}:\n{out}", flush=True)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, time.perf_counter() - t0, seconds


_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_longlong)
# Each source's C entries and their argument types; a unit exports them with
# its suffix.  Every entry returns an int (a launch's cudaError_t).
SIGNATURES = {
    "pathgen": {
        "mcop_priced_smem_bytes": [_I] * 4,
        "mcop_priced_blocks_per_sm": [_I] * 6,
        "mcop_path_smem_bytes": [_I] * 4,
        "mcop_path_blocks_per_sm": [_I] * 4,
        "mcop_pathgen": [_P, _P, _P, _P, _I, _I, _I, _U, _F, _F, _F, _F, _F,
                         _I, _I, _P, _P],
        "mcop_priced_chunk": [_P, _P, _P, _P, _I, _I, _I, _U, _F, _F, _F, _F,
                              _P, _LL, _F, _I, _I, _I, _I, _I, _F, _P, _P]},
    "pathgen_tiled": {
        "mcop_tiled_smem_bytes": [_I] * 4,
        "mcop_tiled_blocks_per_sm": [_I] * 6,
        "mcop_tiled_pathgen": [_P, _I, _P, _P, _P, _I, _I, _I, _U, _F, _F, _F,
                               _F, _F, _I, _I, _P, _P],
        "mcop_tiled_priced_chunk": [_P, _I, _P, _P, _P, _I, _I, _I, _U, _F, _F,
                                    _F, _F, _P, _LL, _F, _I, _I, _I, _I, _I,
                                    _F, _P, _P]},
    "chain": {
        "mcop_chain_smem_bytes": [_I] * 6,
        "mcop_chain_group": [],
        "mcop_chain_blocks_per_sm": [_I] * 6,
        "mcop_priced_chain": [_P, _P, _P, _P, _I, _I, _I, _U, _F, _F, _F, _F,
                              _P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P]},
    "greeks": {
        "mcop_greeks_smem_bytes": [_I] * 4,
        "mcop_greeks_group": [],
        "mcop_greeks_blocks_per_sm": [_I] * 4,
        "mcop_greeks_chunk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _F, _F,
                              _F, _F, _F, _P, _LL, _F, _I, _I, _I, _P, _P],
        "mcop_chain_greeks_chunk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _F,
                                    _F, _F, _F, _F, _P, _LL, _LL, _I, _I, _I,
                                    _I, _P, _P]},
    "pathgen_factored": {
        "mcop_factored_smem_bytes": [_I],
        "mcop_factored_form_smem_bytes": [_I] * 3,
        "mcop_factored_blocks_per_sm": [_I] * 5,
        "mcop_factored_pathgen": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _U, _F, _F, _F, _F, _F, _I, _I, _P, _P],
        "mcop_factored_priced_chunk": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _U, _F, _F, _F, _F, _P, _LL, _F,
                                       _I, _I, _I, _I, _I, _F, _P, _P]},
    "roofline": {
        "mcop_roofline_normals": [_U, _I, _I, _I, _I, _I, _P, _P],
        "mcop_roofline_matmul": [_U, _P, _I, _I, _I, _I, _I, _P, _P, _P]}
}


def bind(path: Path, stem: str, suffix: str) -> dict:
    """The C entries of source ``stem`` in the library at ``path`` (a unit
    of suffix ``suffix``), their signatures declared, by entry name."""
    lib = ctypes.CDLL(str(path))
    entries = {}
    for name, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, name + suffix)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries[name + suffix] = fn
    return entries


@functools.lru_cache(maxsize=None)
def load() -> types.SimpleNamespace:
    """The kernels' C entries with their signatures declared (built first
    if needed), as attributes of one namespace.  Every launching entry
    returns a cudaError_t as int.  Its span, ``mcop.setup.kernels``,
    carries one attribute a unit: the milliseconds to bind its library
    and, where this call compiled it, its nvcc seconds."""
    from ..utils.profiling import span

    with span("mcop.setup.kernels") as sp:
        paths, _, nvcc_s = build()
        entries = {}
        for (name, src, _, suffix), path in zip(UNITS, paths):
            t0 = time.perf_counter()
            entries.update(bind(path, src.stem, suffix))
            unit = {"bind_ms": 1e3 * (time.perf_counter() - t0)}
            if name in nvcc_s:
                unit["nvcc_s"] = nvcc_s[name]
            sp.set(**{name: unit})
    return types.SimpleNamespace(**entries)


def entry(lib: types.SimpleNamespace, stem: str, name: str, bf16: bool,
          seeded: bool = False):
    """The C entry ``name`` of source ``stem`` from the unit that holds the
    float32 or (``bf16``) the bf16 bodies and, where the source splits
    them (``SPLITS``), the seeded (``seeded``) or the noise-in ones."""
    split = SPLITS[stem] is _BY_DTYPE_AND_SEEDED
    return getattr(lib, name + ("_bf16" if bf16 else "")
                   + ("_seeded" if seeded and split else ""))
