"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Builds
run at first use, one ``nvcc`` per source, all started together, into
``csrc/build/`` (git-ignored); a library is named by a hash of its
source and flags, so an edited source rebuilds and an unchanged one is
reused; the shared headers (``csrc/*.cuh``) enter every hash. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = _CSRC / "build"
SOURCES = (
    "flash_fwd_sm90.cu", "flash_bwd_sm90.cu", "flash_fwd.cu", "flash_bwd.cu", "groupnorm_silu_sm90.cu",
    "groupnorm_silu_bwd_sm90.cu", "groupnorm_silu.cu", "adamw_factored.cu",
)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def _target(source: str) -> Path:
    h = hashlib.sha256((_CSRC / source).read_bytes() + " ".join(_FLAGS).encode())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return _BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel.

    Returns ``{"seconds": wall, "logs": {source: nvcc stderr}}``; the
    stderr carries ptxas's register/shared-memory/spill report. Raises
    with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for src in SOURCES:
        target = _target(src)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, target)
    logs, failed = {}, []
    for src, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        logs[src] = out + err
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, target)
    if failed:
        detail = "\n".join(f"--- {s}\n{logs[s]}" for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            target = _target(source)
            if not target.exists():
                build_all()
            lib = ctypes.CDLL(str(target))
            _libs[source] = lib
        return lib
