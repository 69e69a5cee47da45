"""[The benchmark's reference: a frozen copy of ``mrt_tpu_torch/skinning/lbs.py``.]

Linear-blend skinning — counterpart of ``mrt_tpu/skinning/lbs.py``.

The (V,4) sparse joint weights are expanded once at scene compile into a
dense (V,J) matrix W (``dense_weights``, NumPy, the JAX package's code);
per frame the blended per-vertex 3x4 transform is one plain f32 product
``W @ M`` with M the (J,12) flattened joint matrices, as the JAX package
computes it outside any Pallas kernel, followed by the per-vertex affine
apply with a fixed order of adds. Semantics of the reference kept:

* weights are NOT normalized (used as authored, Skinning.metal:26-31)
* a near-zero weight sum falls back to the vertex's FIRST joint index
  (Skinning.metal:28-37)
* normals are transformed with w = 0 (Skinning.metal:42-45)
"""

from __future__ import annotations

import numpy as np
import torch

from .device import require_full_f32
from .math3d import apply_affine


def dense_weights(joint_indices: np.ndarray, joint_weights: np.ndarray, n_joints: int) -> np.ndarray:
    """(V,4) sparse -> (V,J) dense, with the zero-weight fallback baked in.
    Host-side, once at scene compile."""
    v = joint_indices.shape[0]
    w = np.asarray(joint_weights, np.float32)
    wsum = w.sum(axis=1)
    fallback = wsum < 1e-4  # Skinning.metal:28-31
    dense = np.zeros((v, n_joints), np.float32)
    rows = np.arange(v)
    for k in range(joint_indices.shape[1]):
        np.add.at(dense, (rows, np.clip(joint_indices[:, k], 0, n_joints - 1)), w[:, k])
    # fallback weights float4(1,0,0,0) apply to jointMatrices[indices.x] —
    # the vertex's FIRST joint index, not global joint 0 (Skinning.metal:28-37)
    dense[fallback] = 0.0
    first_joint = np.clip(joint_indices[fallback, 0], 0, n_joints - 1)
    dense[np.flatnonzero(fallback), first_joint] = 1.0
    return dense


def skin(weights_dense: torch.Tensor, joint_matrices: torch.Tensor,
         rest_positions: torch.Tensor, rest_normals: torch.Tensor):
    """(V,J) weights, (J,4,4) final joint matrices, (V,3) rest positions and
    normals, all on one device -> (skinned positions (V,3), skinned normals
    (V,3)). On the card the product must run in full f32: TF32 raises."""
    require_full_f32(weights_dense, "lbs.skin")
    j = joint_matrices.shape[0]
    m_flat = joint_matrices[:, :3, :].reshape(j, 12)
    b = torch.matmul(weights_dense, m_flat).reshape(-1, 3, 4)
    return apply_affine(b, rest_positions, True), apply_affine(b, rest_normals, False)


def compose_final_matrices(skin_matrices: np.ndarray, geometry_bind: np.ndarray | None) -> np.ndarray:
    """finalJointMatrix = geometryBindInverse @ skinMatrix @ geometryBind
    (SkinningPass.swift:150). Host-side, per frame (J small)."""
    if geometry_bind is None:
        return skin_matrices
    gb = np.asarray(geometry_bind, np.float32)
    gb_inv = np.linalg.inv(gb)
    return np.einsum("ab,jbc,cd->jad", gb_inv, skin_matrices, gb).astype(np.float32)
