"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` compiles at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into a shared library with a plain C interface under
``build/kernels/`` at the repository root (listed in ``.gitignore``),
and loads with ``ctypes``: pointers and the stream pass as
``c_void_p``, and each C entry point returns the launch's
``cudaGetLastError()`` for its wrapper to raise on.  The compiler's
output (``-Xptxas -v``: registers, shared memory, spills per kernel) is
kept beside each library (:func:`build_log`).  A library's file name
carries a hash of its source and flags, so an edited source never loads
a stale build.  Only sources inside the repository are built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "mux_score", "flash_attention",
           "flash_attention_sm90", "flash_attention_bwd", "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises where there is none (a CUDA
    request must fail, never fall back to the CPU)."""
    found = shutil.which("nvcc")
    if found is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
        if home is None:
            from torch.utils.cpp_extension import CUDA_HOME
            home = CUDA_HOME
        cand = Path(home or "") / "bin" / "nvcc"
        found = str(cand) if home and cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot "
                           "be built on this machine")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all() -> Dict[str, Tuple[float, str]]:
    """Compile every source that has no current build, one ``nvcc``
    process per source, all started together.  Returns
    ``{name: (seconds, compiler log)}`` for the sources it compiled
    (the log holds ``-Xptxas -v``'s registers / shared memory / spills).
    Raises RuntimeError with the compiler's output on a failure."""
    with _lock:
        return _build_locked(list(SOURCES))


def build_log(name: str) -> str:
    """The compiler's output for the current build of ``csrc/<name>.cu``,
    or "" where there is none."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build_locked(names) -> Dict[str, Tuple[float, str]]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        out[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            library_path(name).with_suffix(".log").write_text(log)
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
