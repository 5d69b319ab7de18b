"""Build and load the port's native host engine.

Each host unit (``UNITS``: a ``csrc/host/*.cpp`` source) is a CPython
extension compiled at first use by the host C++ compiler (``$CXX``, else
``c++`` or ``g++`` on PATH) with ``CXX_FLAGS`` into ``build/host/`` at the
root of the checkout, or into ``host/`` under ``$MCOP_KERNEL_CACHE_DIR``
where that names another cache root (``kernels/build.py``), and imported
from there.  The flags carry no ``-ffast-math`` and no ``-march=native``:
the features' sums then round as the JAX package's engine rounds them,
to the bit.  A library's file name carries a hash of its source, the
flags, the compiler's ``--version`` and the Python ABI tag, so an edited
source or another compiler rebuilds and a stale library never loads.  A
library is compiled under a temporary name in the same directory and
renamed into place, so processes that build at once never load a
half-written file.  A failed build raises with the compiler's log; there
is no fallback.  Nothing here runs at import time.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shlex
import shutil
import subprocess
import sysconfig
import threading
import time
import types
from pathlib import Path

from . import build as kernel_build

HOST_CSRC = kernel_build.CSRC / "host"
# Unit name -> source; the extension's module name is "_mcop_<unit>".
UNITS = {"features": HOST_CSRC / "features.cpp",
         "fastcsv": HOST_CSRC / "fastcsv.cpp"}
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
DEFAULT_HOST_DIR = kernel_build.PACKAGE_DIR.parent / "build" / "host"


def host_build_dir() -> Path:
    """``build/host`` of the checkout under the default cache root, else
    ``host/`` under ``$MCOP_KERNEL_CACHE_DIR``."""
    root = kernel_build.build_dir()
    default = root.resolve() == kernel_build.DEFAULT_BUILD_DIR
    return DEFAULT_HOST_DIR if default else root / "host"


def include_flags() -> list:
    """``-I`` flags for Python.h of the running interpreter."""
    paths = sysconfig.get_paths()
    dirs = dict.fromkeys((paths["include"], paths["platinclude"]))
    return [f"-I{d}" for d in dirs]


def compiler() -> list:
    """The host C++ compiler's command: ``$CXX`` split as a shell would,
    else ``c++`` or ``g++`` on PATH."""
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return [path]
    raise FileNotFoundError("no C++ compiler (set CXX or put c++ or g++ on "
                            "PATH); the port's host engine is built from "
                            "source at first use")


@functools.lru_cache(maxsize=None)
def _compiler_version(cmd: tuple) -> str:
    try:
        out = subprocess.run([*cmd, "--version"], capture_output=True,
                             text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(f"host compiler {shlex.join(cmd)} cannot run: "
                           f"{e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"host compiler {shlex.join(cmd)} --version "
                           f"failed ({out.returncode}):\n{out.stdout}"
                           f"{out.stderr}")
    return out.stdout


def library_path(unit: str, src: Path, cmd: tuple) -> Path:
    """Where unit ``unit`` built from ``src`` by compiler ``cmd`` lives."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    h = hashlib.sha256("\0".join((*cmd, *CXX_FLAGS, suffix,
                                  _compiler_version(cmd))).encode())
    h.update(src.read_bytes())
    return host_build_dir() / f"_mcop_{unit}_{h.hexdigest()[:16]}{suffix}"


def build(units: dict | None = None) -> tuple[dict, float, dict]:
    """Compile every unit of ``units`` (name -> source, default ``UNITS``)
    whose library does not exist yet, all at once; returns ({unit: library
    path}, wall seconds spent compiling, {unit: seconds from the common
    start to its compiler's exit})."""
    units = UNITS if units is None else units
    cmd = tuple(compiler())
    libs = {u: library_path(u, src, cmd) for u, src in units.items()}
    todo = [u for u, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs, 0.0, {}
    host_build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for u in todo:
        tag = f"{os.getpid()}.{threading.get_ident()}"
        tmp = libs[u].with_name(f"{libs[u].name}.{tag}.tmp")
        log = libs[u].with_name(f"{libs[u].name}.{tag}.log")
        with open(log, "w") as out:   # a file, not a pipe: nothing blocks
            procs[u] = (tmp, log, subprocess.Popen(
                [*cmd, *CXX_FLAGS, *include_flags(), "-o", str(tmp),
                 str(units[u])], stdout=out, stderr=subprocess.STDOUT))
    seconds = {}
    while len(seconds) < len(procs):
        for u, (_, _, proc) in procs.items():
            if u not in seconds and proc.poll() is not None:
                seconds[u] = round(time.perf_counter() - t0, 3)
        time.sleep(0.01)
    failed = []
    for u, (tmp, log, proc) in procs.items():
        text = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{u}: {shlex.join(cmd)} failed "
                          f"({proc.returncode}):\n{text}")
        else:
            os.replace(tmp, libs[u])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, time.perf_counter() - t0, seconds


def import_library(unit: str, path: Path) -> types.ModuleType:
    """The extension module ``_mcop_<unit>`` in the library at ``path``."""
    loader = importlib.machinery.ExtensionFileLoader(f"_mcop_{unit}",
                                                     str(path))
    spec = importlib.util.spec_from_loader(loader.name, loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def load(unit: str) -> types.ModuleType:
    """The host unit ``unit`` ("features" or "fastcsv"), built first if
    needed."""
    libs, _, _ = build({unit: UNITS[unit]})
    return import_library(unit, libs[unit])
