"""Build of the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface.  :func:`build` compiles it with ``nvcc`` for ``sm_90a`` into a
shared library at first use; the caller loads it with ``ctypes``.  The
library lands in ``_build/`` next to this file, named by the source's stem
and a hash of the source, the headers (``*.cuh``) beside it and the flags,
so an edited source or header is rebuilt and an unchanged one is reused.
Nothing here runs when the module is imported: the CPU tests import it on
machines without ``nvcc``.  Builds of different sources may run at the
same time (one thread each).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source stem -> {"path", "seconds", "cached", "ptxas"} of its last build
build_info: dict = {}


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from source at first use")
    return found


def build(source: Path) -> Path:
    """Compile ``source`` unless an up-to-date build exists; returns the
    library path.  ``build_info[source.stem]`` records the seconds spent
    and the compiler's ``-Xptxas -v`` report."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()
    lib = BUILD_DIR / f"lib{source.stem}-{digest[:16]}.so"
    if lib.exists():
        # a later lookup keeps the record of the build this process made
        if build_info.get(source.stem, {}).get("path") != str(lib):
            log = lib.with_suffix(".log")
            build_info[source.stem] = dict(
                path=str(lib), seconds=0.0, cached=True,
                ptxas=log.read_text() if log.exists() else "")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent build never
    log = res.stdout + res.stderr  # sees a half-written library
    lib.with_suffix(".log").write_text(log)
    build_info[source.stem] = dict(path=str(lib), seconds=seconds,
                                   cached=False, ptxas=log)
    return lib
