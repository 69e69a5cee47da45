"""[The benchmark's reference: a frozen copy of ``mrt_tpu_torch/assets/procedural.py``.]

Procedural stand-in geometry.

The demo scene names large binary assets that the repository does not ship
(dragon.obj, bunny.obj, robot.usdz, the HDR probe). These generators produce
watertight meshes with matching roles: a high-poly "dragon-class" blob for
config 3, a rigged "robot-class" cylinder for config 4, a UV sphere and
ground planes.
"""

from __future__ import annotations

import numpy as np

from .obj import MaterialDef, MeshData, SubmeshData


def _mesh(positions, indices, uvs=None, material: MaterialDef | None = None) -> MeshData:
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    if uvs is None:
        uvs = np.zeros((positions.shape[0], 2), np.float32)
    from .obj import _generate_normals

    normals = _generate_normals(positions, indices)
    return MeshData(
        positions=positions,
        normals=normals,
        uvs=np.asarray(uvs, np.float32),
        submeshes=[SubmeshData(indices=indices, material=material or MaterialDef())],
    )


def uv_sphere(stacks: int = 32, slices: int = 64, radius: float = 1.0, material=None) -> MeshData:
    """Latitude/longitude sphere centred at origin."""
    verts, uvs = [], []
    for i in range(stacks + 1):
        theta = np.pi * i / stacks
        for j in range(slices + 1):
            phi = 2 * np.pi * j / slices
            verts.append(
                (
                    radius * np.sin(theta) * np.cos(phi),
                    radius * np.cos(theta),
                    radius * np.sin(theta) * np.sin(phi),
                )
            )
            uvs.append((j / slices, 1.0 - i / stacks))
    idx = []
    row = slices + 1
    for i in range(stacks):
        for j in range(slices):
            a = i * row + j
            b = a + row
            idx.append((a, b, a + 1))
            idx.append((a + 1, b, b + 1))
    return _mesh(verts, idx, uvs, material)


def plane(size: float = 1.0, y: float = 0.0, material=None) -> MeshData:
    """Unit ground plane in XZ (the analog of AssetResources/plane.obj)."""
    s = size / 2
    verts = [(-s, y, -s), (s, y, -s), (s, y, s), (-s, y, s)]
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    idx = [(0, 2, 1), (0, 3, 2)]
    return _mesh(verts, idx, uvs, material)


def blob(subdivisions: int = 5, radius: float = 0.5, seed: int = 7, material=None) -> MeshData:
    """High-poly displaced icosphere — the "dragon-class" stand-in for the
    missing dragon.obj. 20*4^s tris: s=5 -> 20480, 6 -> 81920, 7 -> 327680,
    8 -> 1310720 (real Stanford-dragon scale is ~871k).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
    for level in range(min(subdivisions, 6)):
        edge_mid: dict = {}
        verts_list = verts.tolist()

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key in edge_mid:
                return edge_mid[key]
            m = np.asarray(verts_list[a]) + np.asarray(verts_list[b])
            m /= np.linalg.norm(m)
            verts_list.append(m.tolist())
            edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)

    # levels past 6 (million-triangle scale) use a vectorized subdivision
    # (np.unique over edges); kept separate so sub<=6 outputs stay
    # bit-identical to the original implementation (golden stability)
    for level in range(6, subdivisions):
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        F = faces.shape[0]
        edges = np.concatenate(
            [
                np.sort(np.stack([a, b], 1), axis=1),
                np.sort(np.stack([b, c], 1), axis=1),
                np.sort(np.stack([c, a], 1), axis=1),
            ]
        )
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = len(verts) + inv
        ab, bc, ca = mid_idx[:F], mid_idx[F : 2 * F], mid_idx[2 * F :]
        faces = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([b, bc, ab], 1),
                np.stack([c, ca, bc], 1),
                np.stack([ab, bc, ca], 1),
            ]
        ).astype(np.int64)
        verts = np.vstack([verts, mids])

    # Smooth pseudo-random radial displacement (sum of low-frequency sines).
    rng = np.random.default_rng(seed)
    disp = np.zeros(len(verts))
    for _ in range(6):
        k = rng.normal(size=3) * 3.0
        phase = rng.uniform(0, 2 * np.pi)
        disp += rng.uniform(0.04, 0.12) * np.sin(verts @ k + phase)
    # slight vertical squash + horizontal stretch for a creature-ish silhouette
    r = radius * (1.0 + disp)
    verts = verts * r[:, None]
    verts[:, 1] *= 0.75
    verts[:, 0] *= 1.35

    u = 0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi)
    v = 0.5 + np.arcsin(np.clip(verts[:, 1] / np.maximum(np.linalg.norm(verts, axis=1), 1e-9), -1, 1)) / np.pi
    return _mesh(verts, faces.astype(np.int32), np.stack([u, v], 1), material)


def skinned_cylinder(
    segments_h: int = 24,
    segments_r: int = 16,
    height: float = 2.0,
    radius: float = 0.25,
    n_joints: int = 4,
    material=None,
):
    """Rigged tube — the "robot-class" stand-in for robot.usdz (config 4).

    Returns (MeshData, joint_indices (V,4) int32, joint_weights (V,4) f32,
    rest_joint_positions (J,3)). Joints form a chain along +Y; weights blend
    linearly between the two nearest joints (the classic bending-tube rig).
    """
    verts, uvs = [], []
    for i in range(segments_h + 1):
        y = height * i / segments_h
        for j in range(segments_r + 1):
            phi = 2 * np.pi * j / segments_r
            verts.append((radius * np.cos(phi), y, radius * np.sin(phi)))
            uvs.append((j / segments_r, i / segments_h))
    idx = []
    row = segments_r + 1
    for i in range(segments_h):
        for j in range(segments_r):
            a = i * row + j
            b = a + row
            idx.append((a, b, a + 1))
            idx.append((a + 1, b, b + 1))
    mesh = _mesh(verts, idx, uvs, material)

    v = np.asarray(verts, np.float32)
    joint_y = np.linspace(0.0, height, n_joints).astype(np.float32)
    seg = height / (n_joints - 1)
    f = np.clip(v[:, 1] / seg, 0.0, n_joints - 1 - 1e-6)
    j0 = np.floor(f).astype(np.int32)
    w1 = (f - j0).astype(np.float32)
    joint_indices = np.zeros((len(v), 4), np.int32)
    joint_weights = np.zeros((len(v), 4), np.float32)
    joint_indices[:, 0] = j0
    joint_indices[:, 1] = np.minimum(j0 + 1, n_joints - 1)
    joint_weights[:, 0] = 1.0 - w1
    joint_weights[:, 1] = w1
    rest_joints = np.stack([np.zeros(n_joints), joint_y, np.zeros(n_joints)], 1).astype(np.float32)
    return mesh, joint_indices, joint_weights, rest_joints
