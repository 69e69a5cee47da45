"""Build and load the hand-written CUDA kernels (``mrt_tpu_torch/csrc``).

Each ``.cu`` source compiles with its own ``nvcc`` (all started together)
for ``sm_90a`` into an object, and the objects link into one shared library
with a plain C interface, ``build/torch_kernels/libmrt_kernels.so``, loaded
with ctypes. ``-fmad=false`` keeps every multiply and add separately
rounded, as the JAX package's unfused arithmetic is. The build happens at
first use, never at import; a stale library (older than a source) is
rebuilt.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB = BUILD_DIR / "libmrt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_lib = None
build_seconds = None  # wall time of the last build in this process (None: cached)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB.exists():
        return True
    newest = max(p.stat().st_mtime for p in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))
    return LIB.stat().st_mtime < newest


def build(verbose: bool = False) -> float:
    """Compile every source in parallel and link the library. Returns the
    build's wall seconds. Raises with the compiler's output on failure."""
    global build_seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
        elif verbose:
            print(out.strip())
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                           *objs, "-o", str(tmp)], capture_output=True, text=True, timeout=600)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, LIB)
    build_seconds = time.perf_counter() - t0
    return build_seconds


def load():
    """The loaded kernel library (built first if missing or stale)."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        build()
    lib = ctypes.CDLL(str(LIB))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.mrt_present.argtypes = [p, p, ll, p]
    lib.mrt_present.restype = i
    lib.mrt_traverse2.argtypes = [p, i, i, i, i, p, p, p, p, p, p, i, i, f, p, p, p, p, p, p, p, p, p]
    lib.mrt_traverse2.restype = i
    _lib = lib
    return lib
