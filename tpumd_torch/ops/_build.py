"""Build the CUDA sources of ``tpumd_torch/csrc`` and load them with ctypes.

The sources have a plain C interface, so nvcc builds them in seconds
without PyTorch's headers.  The library goes to ``build/tpumd_torch/`` at
the repository root, named by a hash of the sources and flags, and is
built at first use; later processes load the cached file.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpumd_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # build (cold) or load (cached) time
    cached: bool
    ptxas_log: str      # registers / shared memory / spills per kernel


_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    global _loaded
    if _loaded is not None:
        return _loaded
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"libtpumd_torch_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    cached = so.exists()
    log = ""
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        log = proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _loaded = KernelLibrary(lib=lib, path=so,
                            seconds=time.perf_counter() - t0,
                            cached=cached, ptxas_log=log)
    return _loaded
