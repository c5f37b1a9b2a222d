"""Build the CUDA sources of ``tpumd_torch/csrc`` and load them with ctypes.

The sources have a plain C interface, so nvcc builds them in seconds
without PyTorch's headers.  One nvcc per source compiles them all at
once, and one more links the objects.  The library goes to
``build/tpumd_torch/`` at the repository root, named by a hash of the
sources, the headers they include from ``csrc`` and the flags, and is
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # build (cold) or load (cached) time
    cached: bool
    ptxas_log: str      # registers / shared memory / spills per kernel


_loaded: KernelLibrary | None = None
_functions: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _compile_all(srcs, objdir: Path) -> tuple[list[Path], str]:
    """One nvcc per source, all started together; returns (objects,
    ptxas log).  Raises if any fails, after every process has ended."""
    nvcc = _nvcc()
    jobs = []
    try:
        for src in srcs:
            obj = objdir / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                   str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errs = [proc.communicate()[1] for _, _, proc in jobs]
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (cmd, _, proc), err in zip(jobs, errs):
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{err}")
    return [obj for _, obj, _ in jobs], "".join(errs)


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
        objdir = BUILD_DIR / f"{so.stem}.{os.getpid()}.obj"
        objdir.mkdir(parents=True, exist_ok=True)
        try:
            objs, log = _compile_all(srcs, objdir)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):"
                                   f"\n{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            shutil.rmtree(objdir, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    _loaded = KernelLibrary(lib=lib, path=so,
                            seconds=time.perf_counter() - t0,
                            cached=cached, ptxas_log=log)
    return _loaded


def kernel_function(name: str, argtypes, restype=ctypes.c_int):
    """A function of the library (built at first use), bound with its
    argument types; a launch function returns the launch's CUDA error
    code (restype c_int).  Pointers and the stream must be c_void_p, or
    ctypes cuts them to 32 bits."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load().lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
        _functions[name] = fn
    return fn
