"""The glTF loader of mrt_tpu_torch against mrt_tpu's on the same inputs.

The skinned glTF and GLB of ``tests/test_gltf.py`` and a rig written by
``assets/rigexport.py`` load to equal arrays in both packages (joint
matrices within 1e-6; weights stay as authored, matrices column-major in
the file), the written rig back to the rig it came from, and a model named
after a GLB resolves it with its skin, as in JAX. The loader fuzz corpus of
``tests/test_loader_fuzz.py`` (truncations, structured corruption of the
accessors, views, skin and attributes) gives each input the same outcome in
both packages: the same exception class, or equal results.
"""

import base64
import json
import struct

import numpy as np
import pytest

from mrt_tpu.assets import gltf as jgltf
from mrt_tpu_torch.assets import gltf, rigexport
from mrt_tpu_torch.skinning import animation as anim
from test_gltf import _make_skinned_gltf
from test_torch_scene_bvh import one_torch_thread  # noqa: F401
from test_torch_usd import assert_same_load, canon, same_outcome, small_rig


def _glb_of(src, tmp_path):
    """The same document in a .glb container (as test_gltf.test_glb_container)."""
    doc = json.loads(src.read_text())
    uri = doc["buffers"][0].pop("uri")
    blob = base64.b64decode(uri.split(",", 1)[1])
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    glb = b"glTF" + struct.pack("<II", 2, 12 + 8 + len(js) + 8 + len(blob))
    glb += struct.pack("<II", len(js), 0x4E4F534A) + js
    glb += struct.pack("<II", len(blob), 0x004E4942) + blob
    p = tmp_path / "rig.glb"
    p.write_bytes(glb)
    return p


@pytest.mark.parametrize("container", ["gltf", "glb"])
def test_skinned_gltf_loads_equal(container, tmp_path):
    src = _make_skinned_gltf(tmp_path)
    path = src if container == "gltf" else _glb_of(src, tmp_path)
    j, p = jgltf.load_gltf(path), gltf.load_gltf(path)
    assert_same_load(j, p)
    mesh, skin = p
    assert mesh.triangle_count == 2 and skin["skeleton"].n_joints == 2
    assert skin["geometry_bind"] is None and skin["animation"].duration == pytest.approx(1.0)


def test_written_glb_loads_equal_and_round_trips(tmp_path):
    """A rig written as GLB (in centimetres) loads to equal arrays in both
    packages, and back to the rig: indices, joint indices and weights
    bit-equal, positions within 1e-6 after the unit change, joint matrices
    within 1e-5."""
    mesh, skin = small_rig(n_joints=5)
    path = rigexport.write_rig(tmp_path, "rig", mesh, skin, unit=100.0)["glb"]
    p = gltf.load_gltf(path)
    assert_same_load(jgltf.load_gltf(path), p)
    pm, ps = p
    assert np.array_equal(pm.submeshes[0].indices, mesh.submeshes[0].indices)
    assert np.array_equal(ps["joint_indices"], skin.joint_indices)
    assert np.array_equal(ps["joint_weights"], skin.joint_weights)
    assert ps["skeleton"].joint_paths == skin.skeleton.joint_paths
    assert np.array_equal(ps["skeleton"].parent_indices, skin.skeleton.parent_indices)
    assert np.abs(pm.positions.astype(np.float64) * 0.01 - mesh.positions).max() <= 1e-6
    d = np.diag([100.0, 100.0, 100.0, 1.0])
    for t in (0.0, 0.37, skin.animation.duration):
        got = np.linalg.inv(d) @ anim.compute_joint_matrices(ps["skeleton"], ps["animation"], t) @ d
        want = anim.compute_joint_matrices(skin.skeleton, skin.animation, t)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_glb_resolution_attaches_skin(tmp_path, monkeypatch):
    """Model("rig") resolves rig.glb through MRT_ASSET_PATH (no USD there)
    and builds its SkinData from the loaded skin, as JAX does."""
    from mrt_tpu.engine import scene as jscene
    from mrt_tpu_torch.engine import scene as pscene

    _glb_of(_make_skinned_gltf(tmp_path), tmp_path)
    monkeypatch.setenv("MRT_ASSET_PATH", str(tmp_path))
    monkeypatch.setattr(jscene, "ASSET_SEARCH_PATHS", [tmp_path] + jscene.ASSET_SEARCH_PATHS)
    for mod in (jscene, pscene):
        monkeypatch.delitem(mod._MESH_CACHE, "rig", raising=False)
    try:
        j, p = jscene.Model("rig"), pscene.Model("rig")
        assert p.mesh.positions.shape == (4, 3)
        assert canon(p.mesh) == canon(j.mesh)
        for f in ("joint_indices", "joint_weights", "rest_joints", "skeleton", "animation",
                  "geometry_bind", "current_time"):
            assert canon(getattr(p.skin, f)) == canon(getattr(j.skin, f)), f
    finally:
        for mod in (jscene, pscene):
            mod._MESH_CACHE.pop("rig", None)


def test_gltf_truncations_same_outcome(tmp_path):
    p = _make_skinned_gltf(tmp_path)
    data = p.read_bytes()
    rng = np.random.default_rng(3)
    q = tmp_path / "fuzz.gltf"
    kinds = []
    for cut in sorted(set(int(x) for x in rng.integers(0, len(data), 40))):
        q.write_bytes(data[:cut])
        kinds.append(same_outcome(jgltf.load_gltf, gltf.load_gltf, q))
    assert "error" in kinds


@pytest.mark.parametrize("k", range(5))
def test_gltf_structured_corruption_same_outcome(k, tmp_path):
    mutations = (
        lambda d: d["accessors"][0].update(count=10 ** 6),
        lambda d: d["accessors"][4].update(componentType=9999),
        lambda d: d["bufferViews"][0].update(byteOffset=10 ** 9),
        lambda d: d["skins"][0].update(joints=[99, 100]),
        lambda d: d["meshes"][0]["primitives"][0]["attributes"].update(POSITION=77),
    )
    d = json.loads(_make_skinned_gltf(tmp_path).read_bytes())
    mutations[k](d)
    q = tmp_path / "fuzz.gltf"
    q.write_text(json.dumps(d))
    same_outcome(jgltf.load_gltf, gltf.load_gltf, q)


def test_glb_byte_flips_same_outcome(tmp_path):
    data = bytearray(_glb_of(_make_skinned_gltf(tmp_path), tmp_path).read_bytes())
    rng = np.random.default_rng(8)
    q = tmp_path / "flip.glb"
    kinds = []
    for _ in range(100):
        pos = int(rng.integers(0, len(data)))
        old = data[pos]
        data[pos] ^= int(rng.integers(1, 256))
        q.write_bytes(bytes(data))
        kinds.append(same_outcome(jgltf.load_gltf, gltf.load_gltf, q))
        data[pos] = old
    assert "ok" in kinds
