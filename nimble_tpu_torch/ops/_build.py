"""Build-at-first-use of the CUDA kernels, loaded with ctypes.

Same pattern as ``nimble_tpu/native.py``: each ``csrc/<name>.cu`` compiles
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
under ``nimble_tpu_torch/_build/`` (git-ignored).  The library's file name
carries a hash of the source, of every ``csrc/*.cuh`` header it includes and
of the flags, so an edited source or header rebuilds and a stale build is
never loaded.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
KERNELS = ("probe_walk_filter", "fused_span_walk", "double_walk",
           "gather_rows")  # csrc/*.cu
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()  # guards _libs and _name_locks
_name_locks: dict = {}    # one lock per kernel: two kernels build at once
_libs: dict = {}
# seconds spent in nvcc per kernel in this process (0.0 = loaded from an
# earlier build); chip_smoke.py reports it
build_seconds: dict = {}
# nvcc's -Xptxas -v report (registers, spills) per kernel built here
ptxas_report: dict = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "nimble_tpu_torch build from source at first use")


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def included_headers(path: Path) -> list:
    """The ``csrc`` headers ``path`` includes (``#include "x.cuh"``), and
    theirs, each once, in the order first included."""
    seen: list = []
    todo = [path]
    while todo:
        for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"',
                              todo.pop(0).read_bytes(), flags=re.M):
            header = CSRC_DIR / inc.decode()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(name: str) -> Path:
    src = source_path(name)
    digest = hashlib.sha256()
    for part in [src, *included_headers(src)]:
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_library(name: str, *, rebuild: bool = False) -> ctypes.CDLL:
    """Build (if needed, or always with ``rebuild``) and load
    ``csrc/<name>.cu``; the loaded library is cached per process."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None and not rebuild:
            return lib
        so = library_path(name)
        if rebuild or not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            # build to a temp name, then rename: a concurrent or cut-off
            # build never leaves a half-written library under the real name
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                     str(source_path(name))],
                    capture_output=True, text=True, timeout=600,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {name}.cu:\n{proc.stderr}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            build_seconds[name] = time.perf_counter() - t0
            ptxas_report[name] = proc.stderr
        else:
            build_seconds.setdefault(name, 0.0)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib


def build_libraries(names, *, rebuild: bool = False) -> dict:
    """:func:`load_library` for every name at once: one nvcc per source,
    all started together.  Returns {name: loaded library}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {n: pool.submit(load_library, n, rebuild=rebuild)
                   for n in names}
        return {n: f.result() for n, f in futures.items()}
