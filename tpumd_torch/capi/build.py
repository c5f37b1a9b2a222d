#!/usr/bin/env python
"""Build the port's C API shim (tpumd_capi.c) into a shared library.

Usage: python tpumd_torch/capi/build.py [outdir]

``build()`` compiles it with gcc at first use, against this interpreter's
headers and libpython, into ``build/tpumd_torch/`` beside the package (the
repository's git-ignored build directory) unless given another directory;
the file name carries a hash of the source, so that an edit rebuilds and
an unchanged source is reused.
"""

import hashlib
import os
import subprocess
import sys
import sysconfig

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "tpumd_capi.c")
BUILD = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                     "tpumd_torch")


def build(outdir=None) -> str:
    """The path of the built library (built where missing)."""
    outdir = outdir or BUILD
    os.makedirs(outdir, exist_ok=True)
    with open(SRC, "rb") as fh:
        key = hashlib.sha256(fh.read()).hexdigest()[:12]
    out = os.path.join(outdir, f"libtpumd_torch-{key}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["gcc", "-shared", "-fPIC", "-O2",
           f"-I{sysconfig.get_path('include')}", SRC, "-o", tmp,
           f"-L{sysconfig.get_config_var('LIBDIR')}",
           f"-lpython{sysconfig.get_config_var('LDVERSION')}"]
    subprocess.run(cmd, check=True)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build(sys.argv[1] if len(sys.argv) > 1 else None))
