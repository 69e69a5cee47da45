"""[The benchmark's reference: a frozen copy of ``mrt_tpu_torch/skinning/animation.py``.]

Skeleton + animation clips — counterpart of ``mrt_tpu/skinning/animation.py``
(NumPy, the same code): the host-side joint-matrix pipeline (``Skeleton``,
``AnimationClip.sample``, ``compute_joint_matrices``, ``advance_time``), the
joint-path fuzzy maps and the procedural swing clip of the robot stand-in.

Joint matrices are computed on the host every frame, as in the reference
(Model.swift:207-261); the per-vertex blend is the device product in
``lbs.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import math3d


# --- joint-path fuzzy mapping (Model.swift:439-499) -----------------------------

def normalize_joint_path(path: str) -> str:
    return "/".join(p for p in path.split("/") if p)


def parent_joint_path(path: str) -> str | None:
    norm = normalize_joint_path(path)
    if "/" not in norm:
        return None
    parent = norm.rsplit("/", 1)[0]
    return parent or None


def build_path_index_map(joint_paths: list[str]) -> dict[str, int]:
    """Exact normalized paths, plus unique suffixes (Model.swift:439-468)."""
    normalized = [normalize_joint_path(p) for p in joint_paths]
    mapping = {p: i for i, p in enumerate(normalized) if p}

    suffix_counts: dict[str, int] = {}
    for p in normalized:
        parts = p.split("/")
        for start in range(1, len(parts)):
            suffix = "/".join(parts[start:])
            suffix_counts[suffix] = suffix_counts.get(suffix, 0) + 1
    for i, p in enumerate(normalized):
        parts = p.split("/")
        for start in range(1, len(parts)):
            suffix = "/".join(parts[start:])
            if suffix_counts[suffix] == 1 and suffix not in mapping:
                mapping[suffix] = i
    return mapping


def build_tail_index_map(joint_paths: list[str]) -> dict[str, int]:
    """Unique last-component map (Model.swift:470-486)."""
    tails = [normalize_joint_path(p).split("/")[-1] for p in joint_paths]
    counts: dict[str, int] = {}
    for t in tails:
        if t:
            counts[t] = counts.get(t, 0) + 1
    return {t: i for i, t in enumerate(tails) if t and counts[t] == 1}


def map_joint_path(path: str, path_to_index: dict, tail_to_index: dict) -> int:
    """Model.swift:488-499: exact/suffix match, then unique-tail, else -1."""
    norm = normalize_joint_path(path)
    if norm in path_to_index:
        return path_to_index[norm]
    tail = norm.split("/")[-1] if norm else norm
    return tail_to_index.get(tail, -1)


# --- skeleton --------------------------------------------------------------------

@dataclasses.dataclass
class Skeleton:
    """Model.swift:346-388. Parents derived from path prefixes; global
    composition assumes parents precede children."""

    joint_paths: list
    rest_transforms: np.ndarray  # (J,4,4)
    inverse_bind_transforms: np.ndarray  # (J,4,4)
    parent_indices: np.ndarray | None = None  # (J,)

    def __post_init__(self):
        if self.parent_indices is None:
            path_to_index = build_path_index_map(self.joint_paths)
            parents = []
            for p in self.joint_paths:
                pp = parent_joint_path(p)
                parents.append(path_to_index.get(pp, -1) if pp else -1)
            self.parent_indices = np.asarray(parents, np.int32)

    def compute_global_transforms(self, local: np.ndarray) -> np.ndarray:
        """globals[i] = globals[parent] @ local[i] when parent < i
        (Model.swift:379-387)."""
        out = np.array(local, np.float32, copy=True)
        for i, parent in enumerate(self.parent_indices):
            if 0 <= parent < i:
                out[i] = out[parent] @ local[i]
        return out


@dataclasses.dataclass
class AnimationClip:
    """Keyed T/R/S tracks per joint (Model.swift:390-414). ``times`` strictly
    increasing; linear interpolation between keys; quaternions re-normalized
    at use (Model.swift:236-248)."""

    joint_paths: list
    times: np.ndarray  # (K,)
    translations: np.ndarray  # (K, J, 3)
    rotations: np.ndarray  # (K, J, 4) quaternions xyzw
    scales: np.ndarray  # (K, J, 3)

    @property
    def duration(self) -> float:
        """max keyed time - min keyed time (Model.swift:403-405)."""
        if len(self.times) == 0:
            return 0.0
        return float(self.times[-1] - self.times[0])

    def sample(self, t: float):
        """Linear interp of T/S, lerp of quaternions (re-normalized by the
        caller as in the reference). Returns (T (J,3), R (J,4), S (J,3))."""
        times = self.times
        if len(times) == 1:
            return self.translations[0], self.rotations[0], self.scales[0]
        t = float(np.clip(t, times[0], times[-1]))
        k = int(np.searchsorted(times, t, side="right") - 1)
        k = min(max(k, 0), len(times) - 2)
        f = (t - times[k]) / max(times[k + 1] - times[k], 1e-9)
        lerp = lambda a: a[k] * (1 - f) + a[k + 1] * f
        q0, q1 = self.rotations[k], self.rotations[k + 1]
        # shortest-path lerp
        flip = (q0 * q1).sum(-1, keepdims=True) < 0
        q1 = np.where(flip, -q1, q1)
        return lerp(self.translations), q0 * (1 - f) + q1 * f, lerp(self.scales)


def compute_joint_matrices(
    skeleton: Skeleton,
    animation: AnimationClip | None,
    current_time: float,
) -> np.ndarray:
    """Model.update (Model.swift:207-261): sample clip -> local transforms
    (animated joints override rest) -> global composition -> global @
    inverseBind. Returns (J,4,4)."""
    local = np.array(skeleton.rest_transforms, np.float32, copy=True)
    if animation is not None and animation.duration > 0:
        t, r, s = animation.sample(current_time)
        path_to_index = build_path_index_map(skeleton.joint_paths)
        tail_to_index = build_tail_index_map(skeleton.joint_paths)
        count = min(len(t), len(r), len(s), len(animation.joint_paths))
        for i in range(count):
            j = map_joint_path(animation.joint_paths[i], path_to_index, tail_to_index)
            if not (0 <= j < len(local)):
                continue
            q = np.asarray(r[i], np.float32)
            norm = np.linalg.norm(q)
            q = q / norm if norm > 1e-4 else np.array([0, 0, 0, 1], np.float32)
            local[j] = math3d.trs_quat(t[i], q, s[i])
    globals_ = skeleton.compute_global_transforms(local)
    return np.einsum("jab,jbc->jac", globals_, skeleton.inverse_bind_transforms).astype(np.float32)


def advance_time(current: float, delta: float, duration: float) -> float:
    """currentTime = fmod(currentTime + dt, duration) (Model.swift:209-215)."""
    if duration <= 0:
        return current
    return float(np.fmod(current + delta, duration))


def make_swing_clip(n_joints: int, rest_joints: np.ndarray, amplitude: float = 0.6, period: float = 2.0, keys: int = 32) -> AnimationClip:
    """Procedural bending animation for the robot-class rig (stand-in for the
    missing robot.usdz clip): each joint swings around Z with phase offset."""
    times = np.linspace(0.0, period, keys).astype(np.float32)
    J = n_joints
    trans = np.zeros((keys, J, 3), np.float32)
    rots = np.zeros((keys, J, 4), np.float32)
    scales = np.ones((keys, J, 3), np.float32)
    # local rest offsets (parent chain along +Y)
    local_offsets = np.zeros((J, 3), np.float32)
    local_offsets[0] = rest_joints[0]
    local_offsets[1:] = rest_joints[1:] - rest_joints[:-1]
    for k, t in enumerate(times):
        angle = amplitude * np.sin(2 * np.pi * t / period)
        for j in range(J):
            a = angle * (j / max(J - 1, 1))
            rots[k, j] = np.array([0, 0, np.sin(a / 2), np.cos(a / 2)], np.float32)
            trans[k, j] = local_offsets[j]
    paths = [f"root/{'/'.join(f'joint{i}' for i in range(j + 1))}" for j in range(J)]
    return AnimationClip(joint_paths=paths, times=times, translations=trans, rotations=rots, scales=scales)
