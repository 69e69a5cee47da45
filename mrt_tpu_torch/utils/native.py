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
    lib.mrt_wide_fetch_clip.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.mrt_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.mrt_obj_parse.restype = ctypes.c_int
    lib.mrt_obj_n_vertices.restype = ctypes.c_int64
    lib.mrt_obj_n_triangles.restype = ctypes.c_int64
    lib.mrt_obj_fetch.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library builds and loads (a query: no path of
    the port picks a route by it)."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def build_wide_bvh_sah(tri_verts: np.ndarray, arity: int, leaf_k: int, spatial: bool = False):
    """Binned-SAH wide topology over (T, 9) f32 [v0 v1 v2] triangles.
    Returns (node_child (Ni,arity) int32, leaf_tri (Nl,leaf_k) int32, depth,
    leaf_clip). ``spatial=True`` lets the builder split references (SBVH):
    ``leaf_clip`` (Nl, 6) f32 [min xyz, max xyz] holds each leaf's clipped
    box, which a refit intersects with the box of the leaf's triangles (so
    valid only for the vertices the builder saw); else it is None."""
    lib = _load()
    tv = np.ascontiguousarray(tri_verts, np.float32)
    rc = lib.mrt_build_wide_bvh_sp(
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), tv.shape[0], arity, leaf_k,
        1 if spatial else 0)
    if rc != 0:
        raise RuntimeError(f"native wide-BVH build failed (rc={rc})")
    ni = int(lib.mrt_wide_n_internal())
    nl = int(lib.mrt_wide_n_leaves())
    depth = int(lib.mrt_wide_depth())
    child = np.empty((ni, arity), np.int32)
    leaf = np.empty((nl, leaf_k), np.int32)
    lib.mrt_wide_fetch(child.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       leaf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    clip = None
    if spatial:
        clip = np.empty((nl, 6), np.float32)
        lib.mrt_wide_fetch_clip(clip.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return child, leaf, depth, clip


def parse_obj_geometry(path: str):
    """The native OBJ geometry parse: (positions (V,3), uvs (V,2), normals
    (V,3) with NaN where unauthored, indices (T,3)) as NumPy arrays, or None
    where the parser rejects the file. Raises where the library does not
    build."""
    lib = _load()
    data = Path(path).read_bytes()
    if lib.mrt_obj_parse(data, len(data)) != 0:
        return None
    v, t = int(lib.mrt_obj_n_vertices()), int(lib.mrt_obj_n_triangles())
    pos, uv, nrm = (np.empty((v, c), np.float32) for c in (3, 2, 3))
    idx = np.empty((t, 3), np.int32)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.mrt_obj_fetch(pos.ctypes.data_as(f32), uv.ctypes.data_as(f32), nrm.ctypes.data_as(f32),
                      idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return pos, uv, nrm, idx
