"""Host-side 4x4 matrix builders matching the reference's simd extensions
(Utilities.swift:302-355) and TRS composition (Model.swift:55-58,501-506).

NumPy row-major here; the reference stores column-major simd matrices. We keep
the same *math*: matrices act on column vectors, composition order matches.
``apply_affine`` applies per-row 3x4 affines to tensors on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate_axis(radians: float, axis) -> np.ndarray:
    """Axis-angle rotation (Utilities.swift:312-325)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    ct, st = np.cos(radians), np.sin(radians)
    ci = 1 - ct
    x, y, z = axis
    m = np.array(
        [
            [ct + x * x * ci, x * y * ci - z * st, x * z * ci + y * st, 0],
            [y * x * ci + z * st, ct + y * y * ci, y * z * ci - x * st, 0],
            [z * x * ci - y * st, z * y * ci + x * st, ct + z * z * ci, 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )
    return m


def rotate_euler(r) -> np.ndarray:
    """rotateX(rx) @ rotateY(ry) @ rotateZ(rz) (Utilities.swift:339-341)."""
    rx, ry, rz = np.asarray(r, np.float32)
    return rotate_axis(rx, [1, 0, 0]) @ rotate_axis(ry, [0, 1, 0]) @ rotate_axis(rz, [0, 0, 1])


def trs(translation, rotation_euler, s) -> np.ndarray:
    """translate @ rotate @ scale (Model.swift:55-58)."""
    return translate(translation) @ rotate_euler(rotation_euler) @ scale(s)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> 4x4 rotation."""
    x, y, z, w = q
    m = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )
    return m


def trs_quat(translation, quat_xyzw, s) -> np.ndarray:
    """matrix4x4_trs (Model.swift:501-506): translate @ rot(q) @ scale."""
    return translate(translation) @ quat_to_matrix(np.asarray(quat_xyzw, np.float32)) @ scale(s)


def apply_affine(M: torch.Tensor, p: torch.Tensor, translate: bool) -> torch.Tensor:
    """Per-row 3x4 affine ``M`` (..., 3, >=3) applied to (V,3) points, with
    each dot product's adds written out in a fixed order (no matmul, no
    FMA); ``translate=False`` drops the fourth column (directions)."""
    out = []
    for r in range(3):
        x = M[:, r, 0] * p[:, 0] + M[:, r, 1] * p[:, 1] + M[:, r, 2] * p[:, 2]
        if translate:
            x = x + M[:, r, 3]
        out.append(x)
    return torch.stack(out, dim=1)
