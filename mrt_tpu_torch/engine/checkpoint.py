"""Checkpoint / resume of renderer state — counterpart of
``mrt_tpu/engine/checkpoint.py``'s single-device ``save`` and ``restore``.

A checkpoint is an ``.npz`` file with the JAX package's keys and
``FORMAT_VERSION``: the accumulation history, motion and depth, the
per-pixel Halton offsets (stored as int32 values, so a generator's state
is never needed), the frame index, the orbit camera, the animation clocks,
the skinned pose buffers and the previous camera. A checkpoint written by
either package restores in the other. The JAX package's hit-priming caches
(``prime_primary``, ``prime_shadow``) are hints the port does not keep: it
writes neither key and ignores both on restore.

``save_dist`` and ``restore_dist`` do the same for the sharded renderers
(``dist/sharding.py``, ``dist/geometry.py``) with the JAX package's
``save_dist`` keys: the row blocks are gathered and rank 0 writes the
whole images; every rank reads the file and keeps its own rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Camera

FORMAT_VERSION = 1


def _fingerprint(renderer) -> tuple:
    """(n_vertices, n_triangles, n_skinned): restore refuses a checkpoint of
    another scene instead of failing later with opaque shape errors."""
    sd = renderer.scene_data
    return (int(sd.positions_obj.shape[0]), int(sd.indices.shape[0]),
            len(renderer.statics.skin_slices))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save(renderer, path: str) -> None:
    """Write the renderer's resumable state to an .npz file."""
    sd = renderer.scene_data
    prev = renderer._previous_camera
    state = dict(
        version=FORMAT_VERSION,
        scene_fingerprint=np.asarray(_fingerprint(renderer), np.int64),
        accum=_host(renderer.accum),
        motion=_host(renderer.motion),
        depth=_host(renderer.depth),
        offsets=_host(renderer.offsets).astype(np.int32),
        frame_index=renderer.frame_index,
        camera_azimuth=renderer.camera_azimuth,
        camera_elevation=renderer.camera_elevation,
        camera_distance=renderer.camera_distance,
        camera_fov_degrees=renderer.camera_fov_degrees,
        scene_time=renderer._scene_time,
        last_skinning_update=(renderer._last_skinning_update
                              if renderer._last_skinning_update is not None else np.nan),
        skin_times=np.asarray([renderer.scene.models[i].skin.current_time
                               for i, _, _ in renderer.statics.skin_slices], np.float64),
        # skinned pose buffers (motion vectors need the previous frame's pose)
        positions_obj=_host(sd.positions_obj),
        prev_positions_obj=_host(sd.prev_positions_obj),
        prev_camera=(np.stack([_host(x) for x in prev]) if prev is not None
                     else np.zeros((0, 3), np.float32)),
    )
    np.savez_compressed(path, **state)


def restore(renderer, path: str) -> None:
    """Load state saved by :func:`save` (of either package) into a renderer
    built over the same scene and settings; raises ValueError on another
    version, resolution or scene."""
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {int(z['version'])} != {FORMAT_VERSION}")
    expected = (renderer.render_height, renderer.render_width, 3)
    if z["accum"].shape != expected:
        raise ValueError(f"checkpoint resolution {z['accum'].shape} != renderer {expected}")
    if "scene_fingerprint" in z:
        fp = tuple(int(x) for x in z["scene_fingerprint"])
        here = _fingerprint(renderer)
        if fp != here:
            raise ValueError(f"checkpoint scene fingerprint {fp} (n_vertices, n_triangles, "
                             f"n_skinned) != renderer scene {here}")
    if renderer._state_size != expected[:2]:
        renderer._allocate_state()  # settings changed since init; size up first
    dev = renderer.device

    def tensor(key, dtype):
        return torch.as_tensor(np.ascontiguousarray(z[key]), dtype=dtype).to(dev)

    renderer.accum = tensor("accum", torch.float32)
    renderer.motion = tensor("motion", torch.float32)
    renderer.depth = tensor("depth", torch.float32)
    renderer.offsets = tensor("offsets", torch.int32)
    renderer.camera_azimuth = float(z["camera_azimuth"])
    renderer.camera_elevation = float(z["camera_elevation"])
    renderer.camera_distance = float(z["camera_distance"])
    renderer.camera_fov_degrees = float(z["camera_fov_degrees"])
    renderer._scene_time = float(z["scene_time"])
    lsu = float(z["last_skinning_update"]) if "last_skinning_update" in z else np.nan
    renderer._last_skinning_update = None if np.isnan(lsu) else lsu
    renderer._joint_matrices = ()  # recomputed from the restored clip times
    if "positions_obj" in z:
        renderer.scene_data = renderer.scene_data._replace(
            positions_obj=tensor("positions_obj", torch.float32),
            prev_positions_obj=tensor("prev_positions_obj", torch.float32))
    for (i, _, _), t in zip(renderer.statics.skin_slices, z["skin_times"]):
        renderer.scene.models[i].skin.current_time = float(t)
    if z["prev_camera"].shape[0] == 4:
        pc = z["prev_camera"].astype(np.float32)
        renderer._previous_camera = Camera(*(torch.as_tensor(pc[k]).to(dev) for k in range(4)))
    # LAST: the property writes above reset frame_index (the accumulation-
    # restart idiom)
    object.__setattr__(renderer, "frame_index", int(z["frame_index"]))


def save_dist(dr, path: str) -> None:
    """Checkpoint a sharded renderer. Collective: every rank calls it. The
    row blocks are gathered over dp, rank 0 writes the file, and every rank
    returns once it is written (a broadcast from rank 0; a failed write
    raises on every rank). The port keeps no workload hints, so
    ``step_hint`` is written as (H,W) int32 zeros for the JAX package's
    ``restore_dist`` to find."""
    full = {k: _host(dr.gather(getattr(dr, k))) for k in ("accum", "motion", "depth", "offsets")}
    prev = dr._previous_camera
    err = None
    if dr.mesh.rank == 0:
        try:
            np.savez_compressed(
                path,
                version=FORMAT_VERSION,
                scene_fingerprint=np.asarray(_fingerprint(dr), np.int64),
                accum=full["accum"],
                motion=full["motion"],
                depth=full["depth"],
                step_hint=np.zeros(full["depth"].shape, np.int32),
                offsets=full["offsets"].astype(np.int32),
                frame_index=dr.frame_index,
                prev_camera=(np.stack([_host(x) for x in prev]) if prev is not None
                             else np.zeros((0, 3), np.float32)),
                joint_matrices=(np.concatenate([_host(m).reshape(-1, 4, 4)
                                                for m in dr._joint_matrices])
                                if dr._joint_matrices else np.zeros((0, 4, 4), np.float32)),
            )
        except Exception as e:  # the other ranks wait on the broadcast below
            err = e
    failed = dr.mesh.broadcast(torch.tensor([0 if err is None else 1], dtype=torch.int32,
                                            device=dr.device))
    if err is not None:
        raise err
    if int(failed.item()):
        raise RuntimeError(f"rank 0 could not write the checkpoint {path}")


def restore_dist(dr, path: str) -> None:
    """Load ``save_dist`` state (of either package) into a sharded renderer
    over the same scene and settings, any mesh shape: each rank keeps its
    rows. Raises ValueError on another version, resolution or scene."""
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {int(z['version'])} != {FORMAT_VERSION}")
    fp = tuple(int(x) for x in z["scene_fingerprint"])
    if fp != _fingerprint(dr):
        raise ValueError(f"checkpoint scene fingerprint {fp} != renderer scene {_fingerprint(dr)}")
    expected = (dr.settings.height, dr.settings.width, 3)
    if z["accum"].shape != expected:
        raise ValueError(f"checkpoint resolution {z['accum'].shape} != {expected}")
    rows = slice(dr.y0, dr.y0 + dr.local_h)

    def block(key, dtype):
        return torch.as_tensor(np.ascontiguousarray(z[key][rows]), dtype=dtype).to(dr.device)

    dr.accum = block("accum", torch.float32)
    dr.motion = block("motion", torch.float32)
    dr.depth = block("depth", torch.float32)
    dr.offsets = block("offsets", torch.int32)
    dr.frame_index = int(z["frame_index"])
    if z["prev_camera"].shape[0] == 4:
        pc = z["prev_camera"].astype(np.float32)
        dr._previous_camera = Camera(*(torch.as_tensor(pc[k]).to(dr.device) for k in range(4)))
    jm = z["joint_matrices"]
    if jm.shape[0] and dr._joint_matrices:
        ends = np.cumsum([m.shape[0] for m in dr._joint_matrices])
        dr.set_joint_matrices(tuple(np.split(jm.astype(np.float32), ends[:-1])))
