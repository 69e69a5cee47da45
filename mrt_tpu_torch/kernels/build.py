"""Build and load the hand-written CUDA kernels (``mrt_tpu_torch/csrc``).

Each ``.cu`` source compiles with its own ``nvcc`` (all started together)
for ``sm_90a`` into an object, and the objects link into one shared library
with a plain C interface, ``build/torch_kernels/libmrt_kernels.so``, loaded
with ctypes. ``-fmad=false`` keeps every multiply and add separately
rounded, as the JAX package's unfused arithmetic is. The build happens at
first use, never at import; a stale library (older than a source) is
rebuilt. Processes that start at once (the ranks of a world) build under a
file lock, each into object files of its own, and the library appears in
one step: a process loads a whole library or builds it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from ..utils import telemetry

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB = BUILD_DIR / "libmrt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_lib = None
# each kernel's resources as `-Xptxas -v` printed them in this process's
# last build, by mangled name: registers, stack, spill stores and loads,
# static shared memory (B)
ptxas = {}


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


@contextlib.contextmanager
def _locked():
    """Hold the build directory's lock (released if the holder dies)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build(verbose: bool = False) -> float:
    """Compile every source in parallel and link the library, under the
    build lock. Returns the build's wall seconds. Raises with the
    compiler's output on failure."""
    with _locked():
        return _build(verbose)


def ensure_built() -> None:
    """Build the library if it is missing or stale (under the build lock)."""
    with _locked():
        if _stale():
            _build()


def _build(verbose: bool = False) -> float:
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
        else:
            ptxas.update(parse_ptxas(out))
            if verbose:
                print(out.strip())
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                           *objs, "-o", str(tmp)], capture_output=True, text=True, timeout=600)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, LIB)
    return time.perf_counter() - t0


def parse_ptxas(text: str) -> dict:
    """{mangled kernel name: {registers, smem, stack, spill_stores,
    spill_loads}} from `-Xptxas -v` output."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return {k: v for k, v in out.items() if "registers" in v}


def load():
    """The loaded kernel library (built first if missing or stale); the
    first load's host seconds, build or cache, go to the counter
    ``setup.kernel_load_s``."""
    if _lib is not None:
        return _lib
    with telemetry.timed("setup.kernel_load_s"):
        return _load()


def _load():
    global _lib
    ensure_built()
    lib = ctypes.CDLL(str(LIB))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.mrt_present.argtypes = [p, p, ll, p]
    lib.mrt_present.restype = i
    lib.mrt_traverse2.argtypes = [p, i, i, i, i, p, p, p, p, p, p, i, i, i, f, p, p, p, p, p, p, p,
                                  p, p]
    lib.mrt_traverse2.restype = i
    lib.mrt_refit_flat.argtypes = [p, i, p, p, p, p, p, p, i, p, i, p, p, p, p, p, p, p]
    lib.mrt_refit_flat.restype = i
    lib.mrt_refit_twolevel.argtypes = [p, i, p, p, p, p, p, p, p, i, p, i, p, p, p, p, p, p, p, p,
                                       ll, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p]
    lib.mrt_refit_twolevel.restype = i
    lib.mrt_sample_start.argtypes = [p, p, p, i, i, i, f, f, p]
    lib.mrt_sample_start.restype = i
    lib.mrt_shade_hit.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i,
                                  f, f, p, i, p]
    lib.mrt_shade_hit.restype = i
    lib.mrt_resolve_shadow.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.mrt_resolve_shadow.restype = i
    lib.mrt_gp_rows.argtypes = [p] * 10 + [i, i, p]
    lib.mrt_gp_rows.restype = i
    lib.mrt_banded_taps.argtypes = [p] * 6 + [i, i, i, p, i, p]
    lib.mrt_banded_taps.restype = i
    lib.mrt_gp_hit_keys.argtypes = [p] * 6 + [i, i, i, p]
    lib.mrt_gp_hit_keys.restype = i
    lib.mrt_gp_gather.argtypes = [p] * 12 + [i, i, i, p]
    lib.mrt_gp_gather.restype = i
    lib.mrt_gp_lane_unpack.argtypes = [p] * 9 + [i, p]
    lib.mrt_gp_lane_unpack.restype = i
    lib.mrt_halton.argtypes = [p, p, p, i, i, p]
    lib.mrt_halton.restype = i
    lib.mrt_svgf_reproject.argtypes = [p] * 19 + [i, i, p]
    lib.mrt_svgf_reproject.restype = i
    lib.mrt_atrous_pass.argtypes = [p] * 10 + [i, i, i, p]
    lib.mrt_atrous_pass.restype = i
    lib.mrt_temporal_resolve.argtypes = [p, p, p, p, i, i, f, f, f, i, p]
    lib.mrt_temporal_resolve.restype = i
    lib.mrt_resize.argtypes = [p, p, p, i, i, i, i, i, p, p, i, p, p, i, i, i, i, i, i, i, i, i,
                               i, p, p]
    lib.mrt_resize.restype = i
    _lib = lib
    return lib
