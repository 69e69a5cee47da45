"""ctypes loader for the shared native host builder (``native/mrt_native.cpp``).

Built on first use with g++ into ``build/torch_native/`` (the same source
and flags as the JAX package's loader, so both produce the same trees). A
failed build raises: there is no silent NumPy fallback, because a tree from
another builder would make the BVH tables differ without notice.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "mrt_native.cpp"
_SO = _REPO / "build" / "torch_native" / "libmrt_native.so"

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{proc.stderr}")
        os.replace(tmp, _SO)  # atomic: concurrent test workers may race here
    lib = ctypes.CDLL(str(_SO))
    lib.mrt_build_wide_bvh_sp.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.mrt_build_wide_bvh_sp.restype = ctypes.c_int
    lib.mrt_wide_n_internal.restype = ctypes.c_int32
    lib.mrt_wide_n_leaves.restype = ctypes.c_int32
    lib.mrt_wide_depth.restype = ctypes.c_int32
    lib.mrt_wide_fetch.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def build_wide_bvh_sah(tri_verts: np.ndarray, arity: int, leaf_k: int):
    """Binned-SAH wide topology over (T, 9) f32 [v0 v1 v2] triangles.
    Returns (node_child (Ni,arity) int32, leaf_tri (Nl,leaf_k) int32, depth)."""
    lib = _load()
    tv = np.ascontiguousarray(tri_verts, np.float32)
    rc = lib.mrt_build_wide_bvh_sp(
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), tv.shape[0], arity, leaf_k, 0)
    if rc != 0:
        raise RuntimeError(f"native wide-BVH build failed (rc={rc})")
    ni = int(lib.mrt_wide_n_internal())
    nl = int(lib.mrt_wide_n_leaves())
    depth = int(lib.mrt_wide_depth())
    child = np.empty((ni, arity), np.int32)
    leaf = np.empty((nl, leaf_k), np.int32)
    lib.mrt_wide_fetch(child.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       leaf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return child, leaf, depth
