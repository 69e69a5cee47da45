"""The USD loaders of mrt_tpu_torch (crate reader and writer, USDA text,
USDZ container, scene extraction, asset resolution) against mrt_tpu's on
the same inputs.

The codecs (LZ4 block, TfFastCompression, the integer codec) give
byte-equal outputs on seeded inputs and on the foreign encoder's streams
(real LZ4 matches, multi-chunk framing, every delta code); the port's
``CrateWriter`` fed what ``scripts/make_usdc_fixture.py:build_crate``
feeds the JAX package's writes the same bytes. Every fixture (the text and
crate tubes, the multi-mesh USDA, the foreign v0.8.0 and v0.6.0 crates,
rigs written by ``assets/rigexport.py``) loads to equal arrays, and the
joint matrices of its skeleton and clip agree within 1e-6. The loader
fuzz corpus of ``tests/test_loader_fuzz.py`` gives each input the same
outcome in both packages: the same exception class, or equal results
(the corrupt-count guard fires on compressed arrays too in both, as
ROADMAP Q3-F3 records). The tube rigged in a 48x48 scene renders three
animated frames within 1 % relative RMSE of JAX's, with equal rays.
"""

import dataclasses
import os
import shutil
import zipfile

import numpy as np
import pytest

import test_usdc_foreign as foreign
from mrt_tpu.assets import usd as jusd
from mrt_tpu.assets import usdc as jusdc
from mrt_tpu.skinning import animation as janim
from mrt_tpu_torch.assets import procedural, rigexport, usd, usdc
from mrt_tpu_torch.skinning import animation as anim
from test_torch_render import rel_rmse
from test_torch_scene_bvh import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TUBE = os.path.join(FIXTURES, "tube.usdz")
TUBE_CRATE = os.path.join(FIXTURES, "tube_crate.usdz")

MULTI_MESH_USDA = """#usda 1.0
(
    upAxis = "Y"
)

def Xform "root"
{
    def Mesh "a"
    {
        int[] faceVertexCounts = [3]
        int[] faceVertexIndices = [0, 1, 2]
        point3f[] points = [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
    }
    def Mesh "b"
    {
        int[] faceVertexCounts = [4]
        int[] faceVertexIndices = [0, 1, 2, 3]
        point3f[] points = [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
        color3f[] primvars:displayColor = [(1, 0, 0)]
    }
}
"""


# ---------------------------------------------------------------------------
# comparison helpers (also used by test_torch_gltf.py)
# ---------------------------------------------------------------------------

def canon(v):
    """A value of either package in a form ``==`` compares exactly: arrays
    by dtype, shape and bytes, floats by their repr (NaN equals NaN),
    dataclasses and prims by their fields."""
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (np.generic, float)):
        return ("scalar", type(v).__name__, repr(v))
    if isinstance(v, dict):
        return ("dict", tuple((canon(k), canon(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(canon(x) for x in v))
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, tuple((f.name, canon(getattr(v, f.name)))
                                        for f in dataclasses.fields(v)))
    if hasattr(v, "attrs") and hasattr(v, "children"):  # a prim of either package
        return ("prim", v.type, v.name, v.path, canon(v.attrs), canon(v.time_samples),
                canon(v.rels), tuple(canon(c) for c in v.children))
    return v


def assert_same_load(j, p):
    """(MeshData, skin_info) of JAX's loader and the port's: every array and
    field equal; joint matrices of the skeleton and clip within 1e-6 at
    eight times over the clip (or at rest)."""
    (jm, js), (pm, ps) = j, p
    assert canon(jm) == canon(pm)
    assert (js is None) == (ps is None)
    if js is None:
        return
    assert canon(js) == canon(ps)
    clip = ps["animation"]
    duration = clip.duration if clip is not None else 0.0
    for t in np.linspace(0.0, duration, 8):
        a = janim.compute_joint_matrices(js["skeleton"], js["animation"], float(t))
        b = anim.compute_joint_matrices(ps["skeleton"], ps["animation"], float(t))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def outcome(fn, *args):
    """("ok", canonical result) or ("error", exception class name)."""
    try:
        return ("ok", canon(fn(*args)))
    except Exception as e:  # the class is what both packages must share
        return ("error", type(e).__name__)


def same_outcome(jfn, pfn, *args):
    a, b = outcome(jfn, *args), outcome(pfn, *args)
    assert a == b, (a[0], b[0], a[1] if a[0] == "error" else "", b[1] if b[0] == "error" else "")
    return a[0]


def small_rig(segments_h=6, segments_r=8, n_joints=4):
    """The port's skinned cylinder with its swing rig: (mesh, SkinData)."""
    from mrt_tpu_torch.engine.appscene import _attach_swing_rig
    from mrt_tpu_torch.engine.scene import Model, SkinData

    mesh, ji, jw, rest = procedural.skinned_cylinder(segments_h=segments_h, segments_r=segments_r,
                                                     n_joints=n_joints)
    m = Model("character", mesh=mesh)
    m.skin = SkinData(joint_indices=ji, joint_weights=jw, rest_joints=rest)
    _attach_swing_rig(m)
    return mesh, m.skin


def _crate(path):
    with zipfile.ZipFile(path) as z:
        return z.read(next(n for n in z.namelist() if n.endswith((".usdc", ".usd"))))


# ---------------------------------------------------------------------------
# codecs and the crate writer
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(11)
    words = [b"points", b"faceVertexIndices", b"joint", b"/root/skel", b"\0"]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 4000))
    return [b"", b"a", bytes(range(256)) * 7, rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
            text, b"hello world" * 50]


@pytest.mark.parametrize("k", range(6))
def test_lz4_and_tf_codecs_byte_equal(k):
    raw = _payloads()[k]
    lz, tf = jusdc.lz4_block_compress(raw), jusdc.tf_compress(raw)
    assert usdc.lz4_block_compress(raw) == lz
    assert usdc.tf_compress(raw) == tf
    assert usdc.lz4_block_decompress(lz, len(raw)) == jusdc.lz4_block_decompress(lz, len(raw)) == raw
    assert usdc.tf_decompress(tf, len(raw)) == jusdc.tf_decompress(tf, len(raw)) == raw
    # the foreign encoder's real match sequences and multi-chunk framing
    flz, ftf = foreign._lz4_compress(raw), foreign._tf_compress(raw)
    assert usdc.lz4_block_decompress(flz, len(raw)) == jusdc.lz4_block_decompress(flz, len(raw))
    assert usdc.tf_decompress(ftf, len(raw)) == jusdc.tf_decompress(ftf, len(raw)) == raw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integer_codec_byte_equal(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.integers(-(2 ** 30), 2 ** 30, 300), np.cumsum(rng.integers(-3, 4, 300)),
                           np.full(40, 7), rng.integers(-40_000, 40_000, 50)])
    enc = jusdc.encode_integers(vals)
    assert usdc.encode_integers(vals) == enc
    assert canon(usdc.decode_integers(enc, len(vals))) == canon(jusdc.decode_integers(enc, len(vals)))
    fenc = foreign._encode_ints(vals)  # every delta code (common, int8, int16, int32)
    assert canon(usdc.decode_integers(fenc, len(vals))) == canon(jusdc.decode_integers(fenc, len(vals)))
    comp = foreign._comp_ints(vals)
    assert canon(usdc.read_compressed_ints(comp, 0, len(vals))) == canon(
        jusdc.read_compressed_ints(comp, 0, len(vals)))


def test_crate_writer_writes_the_same_bytes(monkeypatch):
    import scripts.make_usdc_fixture as mk

    want = mk.build_crate()
    monkeypatch.setattr(mk, "usdc", usdc)
    got = mk.build_crate()
    assert got == want
    assert want == _crate(TUBE_CRATE)  # the checked-in fixture is this writer's output


# ---------------------------------------------------------------------------
# fixtures load to equal arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tube.usdz", "tube_crate.usdz"])
def test_usdz_fixtures_load_equal(name):
    path = os.path.join(FIXTURES, name)
    assert_same_load(jusd.load_usdz(path), usd.load_usdz(path))
    assert_same_load(jusd.load_usd(path), usd.load_usd(path))


def test_multi_mesh_usda_loads_equal():
    j, p = jusd.load_usda_text(MULTI_MESH_USDA), usd.load_usda_text(MULTI_MESH_USDA)
    assert_same_load(j, p)
    assert p[1] is None and len(p[0].submeshes) == 2


@pytest.mark.parametrize("version", [(0, 8, 0), (0, 6, 0)])
def test_foreign_crates_load_equal(version, tmp_path):
    data = foreign.build_foreign_quad(version=version)
    assert canon(usdc.read_crate_prims(data)) == canon(jusdc.read_crate_prims(data))
    assert_same_load(jusd._load_layer_bytes(data), usd._load_layer_bytes(data))
    zp = tmp_path / "foreign.usdz"
    with zipfile.ZipFile(zp, "w", zipfile.ZIP_STORED) as z:
        z.writestr("foreign.usdc", data)
    assert_same_load(jusd.load_usd(zp), usd.load_usd(zp))


@pytest.mark.parametrize("fmt", ["usdc", "usda"])
def test_written_rig_loads_equal_and_round_trips(fmt, tmp_path):
    """A rig written by rigexport (in centimetres) loads to equal arrays in
    both packages, and back to the rig: indices, joint indices and weights
    bit-equal, positions within 1e-6 after the unit change, joint matrices
    within 1e-5."""
    mesh, skin = small_rig()
    path = rigexport.write_rig(tmp_path, "rig", mesh, skin, unit=100.0)[fmt]
    p = usd.load_usd(path)
    assert_same_load(jusd.load_usd(path), p)
    pm, ps = p
    assert np.array_equal(pm.submeshes[0].indices, mesh.submeshes[0].indices)
    assert np.array_equal(ps["joint_indices"], skin.joint_indices)
    assert np.array_equal(ps["joint_weights"], skin.joint_weights)
    assert np.abs(pm.positions.astype(np.float64) * 0.01 - mesh.positions).max() <= 1e-6
    assert np.array_equal(pm.normals, mesh.normals) and np.array_equal(pm.uvs, mesh.uvs)
    d = np.diag([100.0, 100.0, 100.0, 1.0])
    for t in (0.0, 0.37, skin.animation.duration):
        got = np.linalg.inv(d) @ anim.compute_joint_matrices(ps["skeleton"], ps["animation"], t) @ d
        want = anim.compute_joint_matrices(skin.skeleton, skin.animation, t)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the loader fuzz corpus: the same outcome in both packages
# ---------------------------------------------------------------------------

def test_crate_truncations_same_outcome():
    data = _crate(TUBE_CRATE)
    n = len(data)
    for cut in sorted(set(list(range(0, min(n, 128))) + [n // 4, n // 2, 3 * n // 4, n - 1, n])):
        kind = same_outcome(jusdc.read_crate_prims, usdc.read_crate_prims, data[:cut])
        assert kind == ("ok" if cut == n else "error"), cut


@pytest.mark.parametrize("loader", ["read_crate_prims", "_load_layer_bytes"])
def test_crate_byte_flips_same_outcome(loader):
    data = bytearray(_crate(TUBE_CRATE))
    mods = (jusdc, usdc) if loader == "read_crate_prims" else (jusd, usd)
    jfn, pfn = (getattr(m, loader) for m in mods)
    rng = np.random.default_rng(5)
    kinds = []
    for _ in range(200):
        pos = int(rng.integers(0, len(data)))
        old = data[pos]
        data[pos] ^= int(rng.integers(1, 256))
        kinds.append(same_outcome(jfn, pfn, bytes(data)))
        data[pos] = old
    assert "error" in kinds and "ok" in kinds


def test_crate_garbage_same_outcome():
    rng = np.random.default_rng(6)
    for junk in (b"", b"\x00" * 64, b"PXR-USDC" + b"\xff" * 7,
                 rng.integers(0, 256, 256, dtype=np.uint8).tobytes(), b"not a crate at all"):
        assert same_outcome(jusdc.read_crate_prims, usdc.read_crate_prims, junk) == "error"


def _crate_with_compressed_ints(n: int) -> bytes:
    c = foreign.ForeignCrate()
    c.spec("/", jusdc.SPEC_PSEUDO_ROOT, {"upAxis": c.rep_tok_inline("Y")})
    c.spec("/Root", jusdc.SPEC_PRIM, {"typeName": c.rep_tok_inline("Mesh"),
                                      "specifier": c.rep_specifier(0)})
    c.spec("/Root.faceVertexIndices", jusdc.SPEC_ATTRIBUTE,
           {"default": c.rep_int_array_compressed([0] * n)})
    return c.tobytes()


@pytest.mark.parametrize("n", [12, 50_000])
def test_compressed_count_guard_kept(n):
    """The corrupt-count guard (usdc.py:424-428) also refuses a valid
    compressed int array that holds more values than the file has bytes:
    50,000 zeros compress to a few hundred bytes. Both packages refuse it
    (ValueError) and read the 12-value array alike; the port keeps this
    reference quirk on purpose (ROADMAP Q3-F3)."""
    data = _crate_with_compressed_ints(n)
    kind = same_outcome(jusdc.read_crate_prims, usdc.read_crate_prims, data)
    if n > len(data):
        assert outcome(usdc.read_crate_prims, data) == ("error", "ValueError")
    else:
        assert kind == "ok"


# ---------------------------------------------------------------------------
# asset resolution and rendering
# ---------------------------------------------------------------------------

def test_usdz_preferred_resolution(tmp_path, monkeypatch):
    """Model("tube") finds tube.usdz before tube.obj through MRT_ASSET_PATH
    and gets its skin, as in JAX."""
    from mrt_tpu.engine import scene as jscene
    from mrt_tpu_torch.engine import scene as pscene

    shutil.copy(TUBE, tmp_path / "tube.usdz")
    (tmp_path / "tube.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    monkeypatch.setenv("MRT_ASSET_PATH", str(tmp_path))
    monkeypatch.setattr(jscene, "ASSET_SEARCH_PATHS", [tmp_path] + jscene.ASSET_SEARCH_PATHS)
    for mod in (jscene, pscene):
        monkeypatch.delitem(mod._MESH_CACHE, "tube", raising=False)
    try:
        j, p = jscene.Model("tube"), pscene.Model("tube")
        assert p.mesh.positions.shape == (56, 3)
        assert canon(p.mesh) == canon(j.mesh)
        assert canon(dataclasses.asdict(p.skin)) == canon(dataclasses.asdict(j.skin))
        assert p.skin.animation is not None and p.skin.geometry_bind is not None
    finally:
        for mod in (jscene, pscene):
            mod._MESH_CACHE.pop("tube", None)


def test_rigged_tube_renders_like_mrt_tpu():
    """The tube fixture rigged (scale 0.5) over a floor at 48x48, 1 spp, 2
    bounces, motion-adaptive sampling off: three frames at draw(0.1), the
    pose moving, each within 1 % relative RMSE of JAX's with equal rays."""
    from mrt_tpu.engine.renderer import Renderer as JRenderer
    from mrt_tpu.engine.scene import Model as JModel
    from mrt_tpu.engine.scene import Scene as JScene
    from mrt_tpu.engine.scene import SkinData as JSkinData
    from mrt_tpu_torch import UPSCALER_OFF, Model, Renderer, Scene, SkinData

    def scene(scene_cls, model, skin_cls, loader):
        mesh, si = loader(TUBE)
        s = scene_cls(48, 48)
        s.models = [model("tube", mesh=mesh, position=[0, 0, 0], scale=0.5, skin=skin_cls(**si)),
                    model("plane", scale=6)]
        return s

    def configure(r):
        r.upscaler_mode = "off"
        r.samples_per_pixel = 1
        r.max_bounces = 2
        r.use_motion_adaptive_sampling = False

    rj = JRenderer(scene(JScene, JModel, JSkinData, jusd.load_usdz), 48, 48, seed=2)
    configure(rj)
    rp = None
    poses = []
    for f in range(3):
        rj.draw(0.1)
        if rp is None:  # JAX's offsets have the render size after its first draw
            rp = Renderer(scene(Scene, Model, SkinData, usd.load_usdz), 48, 48, device="cpu",
                          offsets=np.asarray(rj.offsets))
            configure(rp)
            assert rp.upscaler_mode == UPSCALER_OFF
        rp.draw(0.1)
        aj, ap = np.asarray(rj.accum), rp.accum.numpy()
        assert np.isfinite(ap).all()
        assert rel_rmse(ap, aj) < 1e-2, (f, rel_rmse(ap, aj))
        assert int(rp.last_rays_traced) == int(rj.last_rays_traced), f
        poses.append(rp.scene_data.positions_obj[:56].numpy().copy())
    assert np.abs(poses[2] - poses[0]).max() > 0.05  # the clip moves the tube's top


@pytest.mark.parametrize("fmt", ["usdc", "usda", "glb"])
def test_app_scene_robot_from_file_matches_in_memory_rig(fmt, tmp_path):
    """Run H's path at 48x48: the app scene's robot resolved from a file
    written in centimetres (frame_profile.write_character; for "usda" and
    "glb" the file alone is offered under the robot's name) keeps the 0.01
    scale and its own skeleton and clip, and renders three animated frames
    within 1 % relative RMSE of the same rig held in memory in metres at
    scale 1, with rays within 0.5 % (the skinned positions agree to
    rounding, so a grazing ray may flip)."""
    from mrt_tpu_torch import Model, Renderer, make_app_scene
    from mrt_tpu_torch.utils import frame_profile as FP

    mesh, skin = FP.character(segments=8, n_joints=4)
    paths = FP.write_character(tmp_path / "all", mesh, skin)
    d = tmp_path / "one"
    d.mkdir()
    shutil.copy(paths[fmt], d / ("robot.glb" if fmt == "glb" else "robot.usdz"))
    with FP.robot_asset(d):
        from_file = make_app_scene(48, 48, include_robot=True, asset_models=False)
    robot = from_file.models[0]
    assert robot.name == "robot" and robot.scale == 0.01 and robot.mesh.positions.shape[0] == 81
    assert robot.skin.skeleton.joint_paths == skin.skeleton.joint_paths
    in_memory = make_app_scene(48, 48, include_robot=True, asset_models=False)
    in_memory.models[0] = Model("robot", mesh=mesh, position=[-0.5, 0.0, 1.0], skin=skin)
    rs = []
    for scene in (from_file, in_memory):
        r = Renderer(scene, 48, 48, device="cpu", seed=1)
        FP.configure(r, motion_adaptive=True, bounces=2)
        rs.append(r)
    for _ in range(3):
        a, b = (r.draw(1 / 15).numpy() for r in rs)
        assert rel_rmse(a, b) < 1e-2
        ra, rb = (int(r.last_rays_traced) for r in rs)
        assert abs(ra - rb) <= 0.005 * rb
    assert float(rs[0].motion.abs().max()) > 0.0
