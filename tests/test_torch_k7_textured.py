"""K7's textured instantiations: the host side of their Hopper design.

The kernel reads only the float4 groups of the packed texel that a hit's
maps read (``kernels/wavefront.py:map_groups``, ``hit_groups``), and the
mip chains through ``TextureAtlas.texels4``, a float4 copy of the texels
made where the atlas goes onto its device. Held here against the JAX
package on seeded inputs: each map's groups hold every channel that
``mrt_tpu.assets.texture.sample_packed`` feeds the map and no group
without one; the groups of run F's and run N's floor; ``texels4`` equal to
the texels channel for channel. Also the measuring tools' CPU paths:
``frame_profile.k7_frame``, ``gp_compare.k7_rows_frame`` and
``k2_compare.k7_summary``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.assets import texture as jtex
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu_torch import Renderer, convert
from mrt_tpu_torch.assets import texture as tex
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.dist.geometry import GeometryShardedRenderer
from mrt_tpu_torch.engine.appscene import make_app_scene
from mrt_tpu_torch.kernels import wavefront as W
from mrt_tpu_torch.utils import frame_profile as FP
from mrt_tpu_torch.utils import gp_compare, k2_compare
from test_torch_scene_bvh import _bits_equal, one_torch_thread  # noqa: F401

ALL_MAPS = tuple(range(tex.N_MAP_TYPES))
MAP_BITS = {jtex.MAP_BASECOLOR: T.MATERIAL_TEXTURE_BASECOLOR,
            jtex.MAP_NORMAL: T.MATERIAL_TEXTURE_NORMAL,
            jtex.MAP_ROUGHNESS: T.MATERIAL_TEXTURE_ROUGHNESS,
            jtex.MAP_METALLIC: T.MATERIAL_TEXTURE_METALLIC, jtex.MAP_AO: T.MATERIAL_TEXTURE_AO,
            jtex.MAP_OPACITY: T.MATERIAL_TEXTURE_OPACITY,
            jtex.MAP_EMISSION: T.MATERIAL_TEXTURE_EMISSION}


def _jax_groups(maps) -> int:
    """The float4 groups holding a channel of one of ``maps`` in the JAX
    package's packed layout."""
    out = 0
    for m in maps:
        c0, cw = jtex._PACKED_SLICE[m]
        for c in range(c0, c0 + cw):
            out |= 1 << (c // 4)
    return out


def _jax_atlas(seed: int = 5):
    """A JAX atlas of one resource with every map (seeded, odd sizes, so the
    packing resamples) and seeded uvs inside and outside [0, 1]."""
    rng = np.random.default_rng(seed)
    maps = {m: rng.random((9, 7, 3) if m in (jtex.MAP_BASECOLOR, jtex.MAP_NORMAL,
                                               jtex.MAP_EMISSION) else (6, 11)).astype(np.float32)
            for m in ALL_MAPS}
    b = jtex.AtlasBuilder()
    b.add_resource(maps)
    uv = (rng.random((512, 2)) * 3.0 - 1.0).astype(np.float32)
    return b.build(), jnp.zeros(512, jnp.int32), jnp.asarray(uv)


def _poisoned(atlas, keep: int):
    """``atlas`` with every packed channel outside the groups ``keep`` NaN."""
    packed = np.array(atlas.packed)
    for q in range(tex.PACKED_C // 4):
        if not (keep >> q) & 1:
            packed[..., 4 * q:4 * q + 4] = np.nan
    return atlas._replace(packed=jnp.asarray(packed))


@pytest.mark.parametrize("m", ALL_MAPS)
def test_packed_groups_hold_the_channels_jax_feeds_each_map(m):
    """Map m's groups (``packed_groups``) are those of its channels in the
    JAX package's layout; JAX's sample of the map is bit-equal with every
    other group poisoned, and poisoning any one of its groups changes it."""
    g = W.packed_groups(m)
    assert g == _jax_groups([m]) and g
    atlas, res, uv = _jax_atlas()
    want = np.asarray(jtex.packed_map(jtex.sample_packed(atlas, res, uv), m))
    got = np.asarray(jtex.packed_map(jtex.sample_packed(_poisoned(atlas, g), res, uv), m))
    assert _bits_equal(want, got)
    for q in range(tex.PACKED_C // 4):
        if (g >> q) & 1:
            hit = np.asarray(jtex.packed_map(
                jtex.sample_packed(_poisoned(atlas, g & ~(1 << q)), res, uv), m))
            assert np.isnan(hit).any(), q


@pytest.mark.parametrize("ao", [False, True])
@pytest.mark.parametrize("m", ALL_MAPS)
def test_hit_groups_of_one_map_among_all(m, ao):
    """A scene with every map, a hit whose material has one: the groups of
    that map alone (the AO map's only where AO is on)."""
    word = W.map_groups((True,) * tex.N_MAP_TYPES)
    want = 0 if (m == jtex.MAP_AO and not ao) else _jax_groups([m])
    assert W.hit_groups(word, MAP_BITS[m], ao) == want
    # a map the scene lacks is never read, whatever the material says
    others = tuple(k != m for k in ALL_MAPS)
    assert W.hit_groups(W.map_groups(others), MAP_BITS[m], ao) == 0


def _floor_scene(mipmaps: bool):
    """Run F's (mipmaps) or N's scene at 48x32 with its floor maps cut to 32²
    and 16² (the same seeded checker and normal map generator)."""
    from mrt_tpu_torch.assets import procedural
    from mrt_tpu_torch.assets.obj import MaterialDef

    s = make_app_scene(48, 32, include_robot=False, asset_models=False,
                       dragon_subdivisions=None)
    checker, nmap = FP.floor_maps(0, base=32, normal=32)
    floor = next(m for m in s.models if m.name == "plane")
    floor.mesh = procedural.plane(material=MaterialDef(name="floor", map_base_color=checker,
                                                       map_normal=nmap[:16, :16]))
    return s


@pytest.mark.parametrize("run", ["F", "N"])
def test_hit_groups_of_the_textured_runs(run):
    """Run F's and run N's floor (a base-colour and a normal map): its hits
    read groups 0 and 1 of 4 (channels 0-7: base colour 0-2, normal 3-5),
    every channel JAX feeds those maps, and the other resources none; a
    sample of the floor with groups 2 and 3 poisoned is JAX's, bit for bit,
    in both maps."""
    sd, st = _floor_scene(run == "F").compile("cpu")
    word = W.map_groups(st.any_map)
    assert st.any_map[tex.MAP_BASECOLOR] and st.any_map[tex.MAP_NORMAL]
    assert sum(st.any_map) == 2
    bits = sd.materials.texture_flags.tolist()
    groups = [W.hit_groups(word, b) for b in bits]
    floor = [k for k, b in enumerate(bits) if b]
    assert floor and all(groups[k] == 0b0011 for k in floor)
    assert all(g == 0 for k, g in enumerate(groups) if k not in floor)
    assert _jax_groups([jtex.MAP_BASECOLOR, jtex.MAP_NORMAL]) == 0b0011
    # the port's packed atlas is the JAX package's (test_torch_extras), so
    # JAX's sampler on it stands for both
    ja = jtex.TextureAtlas(*(jnp.asarray(np.asarray(getattr(sd.atlas, f)))
                             for f in jtex.TextureAtlas._fields[:-1]))
    rng = np.random.default_rng(7)
    res = jnp.full(256, floor[0], jnp.int32)
    uv = jnp.asarray((rng.random((256, 2)) * 4.0 - 2.0).astype(np.float32))
    full = jtex.sample_packed(ja, res, uv)
    cut = jtex.sample_packed(_poisoned(ja, 0b0011), res, uv)
    for m in (jtex.MAP_BASECOLOR, jtex.MAP_NORMAL):
        assert _bits_equal(np.asarray(jtex.packed_map(full, m)), np.asarray(jtex.packed_map(cut, m)))


def test_texels4_is_texels_with_a_zero_channel():
    """``with_texels4``: the texels' floats, bit for bit, and a zero fourth
    channel; equal to the JAX package's texels built from the same seeded
    maps; a compiled scene and a converted JAX scene carry it, and a
    bilinear tap read through it is the port's and JAX's."""
    rng = np.random.default_rng(3)
    maps = [{jtex.MAP_BASECOLOR: rng.random((16, 16, 3)).astype(np.float32),
             jtex.MAP_NORMAL: rng.random((8, 8, 3)).astype(np.float32)},
            {jtex.MAP_ROUGHNESS: rng.random((13, 7)).astype(np.float32)}]
    jb, pb = jtex.AtlasBuilder(), tex.AtlasBuilder()
    for m in maps:
        jb.add_resource(m)
        pb.add_resource(m)
    ja, pa = jb.build(), tex.with_texels4(pb.build())
    t4 = pa.texels4
    assert t4.shape == (*pa.texels.shape[:2], 4) and t4.dtype == torch.float32
    assert _bits_equal(np.asarray(ja.texels), t4[..., :3].numpy())
    assert (t4[..., 3].view(torch.int32) == 0).all()
    # the trilinear sample through the float4 copy (the kernel's reads)
    res = torch.as_tensor(rng.integers(0, 2, 512).astype(np.int32))
    uv = torch.as_tensor((rng.random((512, 2)) * 3 - 1).astype(np.float32))
    lod = torch.as_tensor((rng.random(512) * 8 - 2).astype(np.float32))
    via4 = tex.sample_trilinear(pa._replace(texels=t4[..., :3].contiguous()), res,
                                tex.MAP_BASECOLOR, uv, lod)
    assert torch.equal(via4.view(torch.int32),
                       tex.sample_trilinear(pa, res, tex.MAP_BASECOLOR, uv, lod).view(torch.int32))
    jt = np.asarray(jtex.sample_trilinear(ja, jnp.asarray(res.numpy()), jtex.MAP_BASECOLOR,
                                          jnp.asarray(uv.numpy()), jnp.asarray(lod.numpy())))
    assert np.abs(jt - via4.numpy()).max() <= 1e-6
    sd, _ = _floor_scene(True).compile("cpu")
    assert torch.equal(sd.atlas.texels4[..., :3], sd.atlas.texels)
    js = JScene(16, 16)
    js.models = [JModel("sphere", position=[0, 0.5, 0], scale=0.5), JModel("plane", scale=10)]
    jd, _ = js.compile()
    conv = convert.scene_data(jd, "cpu").atlas
    assert _bits_equal(np.asarray(jd.atlas.texels), conv.texels4[..., :3].numpy())
    assert (conv.texels4[..., 3] == 0).all()


@pytest.mark.parametrize("run", ["F", "N"])
def test_k7_frame_counts_a_frames_launches(run):
    """``frame_profile.k7_frame`` on the CPU: the instantiation of run F
    (``maps_mips``) and run N (``maps``), one launch a step, a bound for
    each and the first launch over every lane (no profiler here)."""
    r = Renderer(_floor_scene(run == "F"), 48, 32, device="cpu")
    FP.configure(r, mipmaps=run == "F")
    FP.frame(r)
    calls = []
    orig = W.shade_hit

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    W.shade_hit = counted
    try:
        out = FP.k7_frame(r)
    finally:
        W.shade_hit = orig
    assert out["variant"] == ("maps_mips" if run == "F" else "maps")
    assert out["launches"] == len(calls) > 2
    assert out["bound_ms"] > out["first"]["bound_ms"] > 0
    assert out["first"]["lanes"] == 48 * 32 and out["first"]["profiler_ms"] is None


@pytest.mark.parametrize("job", ["rows_maps", "rows_maps_mips", "rows_maps_taps"])
def test_k7_rows_frame_takes_the_textured_lane_row_forms(job):
    """``gp_compare``'s lane-row K7 jobs at gp=1 on the CPU: each takes the
    instantiation it is named for, over a frame's steps."""
    textured, offsets = gp_compare.gp_job_settings(_floor_scene(False), 48, 32, "cpu")
    settings, banded = gp_compare.k7_rows_jobs(textured)[job]
    r = GeometryShardedRenderer(_floor_scene(False), settings, banded=banded, offsets=offsets,
                                device="cpu")
    out = gp_compare.k7_rows_frame(r)
    assert out["variant"] == job and out["launches"] > 2 and out["frame_ms"] is None


def test_k7_summary_reads_k7_per_run_and_tree():
    """``k2_compare.k7_summary``: K7's ms per warm frame of runs F, N, A and
    J per tree (mean and spread of its runs), with frame_profile --k7 the
    bound and its share, and each tree's resources."""
    def line(run, ms, bound=None):
        out = dict(run=run, stage_s=dict(shade_hit=ms / 1e3),
                   stage_launches=dict(shade_hit=22))
        if bound is not None:
            out["k7"] = dict(variant="maps", bound_ms=bound, launches=22,
                             first=dict(profiler_ms=0.3, bound_ms=0.1))
        return out

    runs = {"F": {"parent": [line("F", 2.6, 0.65), line("F", 2.5, 0.65)],
                  "this": [line("F", 2.0, 0.65), line("F", 2.1, 0.65)]},
            "N": {"this": [line("N", 1.9), line("N", 1.9)]}}
    s = k2_compare.k7_summary(runs, {"this": {"k": dict(registers=80)}})
    assert s["F"]["parent"]["mean_ms"] == pytest.approx(2.55)
    assert s["F"]["this"]["spread_ms"] == pytest.approx(0.1)
    assert s["F"]["this"]["bound_share"] == pytest.approx(0.65 / 2.05)
    assert s["F"]["parent"]["first_profiler_ms"] == [0.3, 0.3]
    assert "bound_ms" not in s["N"]["this"] and s["N"]["this"]["launches"] == 22
    assert s["resources"]["this"] == {"k": dict(registers=80)}
    assert "A" not in s


def test_frame_profile_refuses_an_unknown_run():
    with pytest.raises(SystemExit):
        FP.main(["--runs", "A,Z"])
