"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``isoforest_tpu_torch/csrc/`` has a plain C interface and
becomes its own shared library for ``sm_90a``, built at first use into
``build/isoforest_tpu_torch/`` beside the package (the ``build/`` directory
is git-ignored), or into ``ISOFOREST_TPU_TORCH_BUILD_DIR`` when that is set
at import. Processes that build one source at once are safe: each compiles
to a file of its own and renames it into place. A library's file name carries a hash of its source and of
the nvcc flags, so an edited kernel or a change of flags is rebuilt and a
stale library never loaded. Each build reports its seconds as an
``NVCC_BUILD_EVENT`` (:mod:`..utils.monitoring`), which the resource plane
counts as a compile. Nothing here runs at import: the CPU-only test
machine imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Sequence

from ..utils import monitoring

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR_ENV = "ISOFOREST_TPU_TORCH_BUILD_DIR"
BUILD_DIR = pathlib.Path(os.environ.get(BUILD_DIR_ENV) or PACKAGE_DIR.parent / "build" / "isoforest_tpu_torch")

SOURCES = {"dense": "dense.cu", "path_walk": "path_walk.cu", "ext_gemm": "ext_gemm.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where source ``name`` built with ``NVCC_FLAGS`` lives: the file name
    carries a hash of both."""
    digest = hashlib.sha256()
    digest.update((CSRC_DIR / SOURCES[name]).read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES), ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: {"seconds", "log"}}`` for
    the ones compiled; ``log`` holds nvcc's output (``-Xptxas -v`` register
    and shared-memory report when ``ptxas_verbose``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()),
               "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())

    def finish(item):
        """Wait for one nvcc; its seconds end when it ends, not when the
        ones before it in the loop do."""
        name, (proc, tmp, target, t0) = item
        log, _ = proc.communicate()
        return name, proc.returncode, log, time.perf_counter() - t0

    report = {}
    failed = []
    with ThreadPoolExecutor(max_workers=max(len(procs), 1)) as pool:
        finished = list(pool.map(finish, procs.items()))
    for name, returncode, log, seconds in finished:
        if returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]} (exit {returncode}):\n{log}")
            continue
        _, tmp, target, _ = procs[name]
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        report[name] = {"seconds": seconds, "log": log}
        monitoring.record_event_duration_secs(monitoring.NVCC_BUILD_EVENT, seconds, key=f"nvcc:{name}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The built library ``name`` (building it on first use), with
    ``argtypes`` set from ``signatures`` and ``restype`` ``c_int`` for every
    entry: each returns the ``cudaError_t`` of its launch."""
    lib = _LIBS.get(name)
    if lib is None:
        if not library_path(name).exists():
            build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            entry = getattr(lib, fn)
            entry.argtypes = list(argtypes)
            entry.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
