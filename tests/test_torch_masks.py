"""K2's two new pieces against live mrt_tpu: geometry masks, on
tests/test_masks.py's scenes (a floor lit by the default area light with a
sphere hovering between light and floor, whose geometry mask decides
whether it casts a shadow; camera rays carry RAY_MASK_PRIMARY, so they see
LIGHT geometry, bounce rays RAY_MASK_SECONDARY and shadow rays
RAY_MASK_SHADOW, which skip it), and the child sort of tables above
2^20 - 1 rows (``sorted_candidates``; its traversal is in
tests/test_torch_traversal.py).

Tolerances: traversal hits under each ray mask equal to mrt_tpu's (the
triangle and the occlusion flag; t within 1e-5 relative and 1e-6 absolute:
XLA:CPU contracts the leaf test's multiply-adds, ROADMAP Q3-P1, and one
grazing hit of these rays differs by 1.7e-6 relative); the light-masked
render within 1e-2 relative RMSE of mrt_tpu (the bar tests/test_golden.py
uses), rays equal; ``sorted_candidates`` ids and validity equal to
``wide._sorted_candidates``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu import UPSCALER_OFF as J_OFF
from mrt_tpu import Renderer as JRenderer
from mrt_tpu.bvh import twolevel as jtl
from mrt_tpu.bvh import wide as jwide
from mrt_tpu.core import types as JT
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu_torch import convert
from mrt_tpu_torch.bvh import twolevel
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.kernels import traverse2
from test_torch_render import port_like, rel_rmse
from test_torch_scene_bvh import jax_sah, one_torch_thread  # noqa: F401


def _renderer(occluder_mask, fused=None, size=48):
    """tests/test_masks.py:_renderer: the sphere at y=1.3 between the area
    light (y=1.98) and the floor; one frame drawn, so that its pixel offsets
    have the render size (``port_like`` takes them)."""
    scene = JScene(width=size, height=size)
    scene.models = [
        JModel("sphere", position=[0.0, 1.3, 0.0], scale=0.3, geometry_mask=occluder_mask),
        JModel("plane", position=[0, 0, 0], scale=10),
    ]
    with jax_sah():
        r = JRenderer(scene, output_width=size, output_height=size, seed=5)
    r.upscaler_mode = J_OFF
    r.samples_per_pixel = 2
    r.max_bounces = 2
    r.use_motion_adaptive_sampling = False
    if fused is not None:
        r.fuse_shadow_rays = fused
    r.draw()
    return r


def _tables(mask):
    """The JAX renderer's BVH and the port's own build of the same scene."""
    rj = _renderer(mask)
    ps = convert.scene(rj.scene)
    pd, _ = ps.compile("cpu")
    return rj.bvh, twolevel.build(ps.models, pd, ps.host_mirror)


def test_mask_plumbing_closest_hit():
    """tests/test_masks.py's rays aimed at the light-masked sphere: PRIMARY
    sees it, SECONDARY and SHADOW skip it, no mask sees it; as in mrt_tpu."""
    jb, pb = _tables(T.GEOMETRY_MASK_LIGHT)
    assert jb.has_masks and pb.has_masks
    n = 8
    o = np.tile(np.asarray([[0.0, 1.3, 3.0]], np.float32), (n, 1))
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    inf = np.full((n,), np.inf, np.float32)
    jr = JT.Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(inf))
    pr = T.Rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(inf))

    def masks(bits):
        return jnp.full((n,), bits, jnp.int32), torch.full((n,), bits, dtype=torch.int32)

    for bits, seen in ((T.RAY_MASK_PRIMARY, True), (T.RAY_MASK_SECONDARY, False), (None, True)):
        jm, pm = masks(bits) if bits is not None else (None, None)
        jh = jtl.closest_hit(jb, jr, ray_mask=jm, chunks=1)
        ph = twolevel.closest_hit(pb, pr, ray_mask=pm)
        assert np.array_equal(np.asarray(jh.triangle), ph.triangle.numpy()), bits
        assert bool((ph.triangle >= 0).all()) == seen and bool((ph.triangle < 0).all()) != seen
    jm, pm = masks(T.RAY_MASK_SHADOW)
    assert not bool(jnp.any(jtl.any_hit(jb, jr, ray_mask=jm, chunks=1)))
    assert not bool(twolevel.any_hit(pb, pr, ray_mask=pm).any())
    assert bool(twolevel.any_hit(pb, pr).all())


@pytest.mark.parametrize("bits", [T.RAY_MASK_PRIMARY, T.RAY_MASK_SECONDARY],
                         ids=["primary", "secondary_and_shadow"])
def test_traverse_plain_masks_match_jax(bits):
    """4096 random rays from above the floor under one ray mask (secondary
    and shadow rays carry the same bits) and under a random mix of the
    three on the same rays: ``traverse_plain``'s closest hits, occlusion and
    per-lane pops (the order the masked K2 must equal on the card) on the
    JAX package's own table equal ``closest_hit``/``any_hit`` with
    ``ray_mask`` and ``count_pops``."""
    jb, _ = _tables(T.GEOMETRY_MASK_LIGHT)
    pb = convert.bvh(jb, device="cpu")
    rng = np.random.default_rng(bits)
    n = 4096
    o = np.stack([rng.uniform(-1, 1, n), rng.uniform(0.2, 1.9, n), rng.uniform(-1, 1, n)], 1)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    dist = rng.uniform(0.5, 3.0, n).astype(np.float32)
    mixed = rng.choice([T.RAY_MASK_PRIMARY, T.RAY_MASK_SECONDARY, T.RAY_MASK_SHADOW], n)
    on_sphere = []
    for m in (np.full(n, bits), mixed):
        m = m.astype(np.int32)
        jr = JT.Rays(jnp.asarray(o), jnp.asarray(d), jnp.full((n,), jnp.inf, jnp.float32))
        jh, jpops = jtl.closest_hit(jb, jr, ray_mask=jnp.asarray(m), chunks=1, count_pops=True)
        args = (pb.table, pb.n_internal, pb.n_leaf, pb.tlas_n, pb.stack_size, torch.as_tensor(o),
                torch.as_tensor(d))
        pc = traverse2.traverse_plain(*args, torch.full((n,), float("inf")),
                                      torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool),
                                      ray_mask=torch.as_tensor(m))
        ph = twolevel._hits(pb, pc)
        assert np.array_equal(np.asarray(jh.triangle), ph.triangle.numpy())
        assert np.array_equal(np.asarray(jpops), pc.pops.numpy())
        hit = ph.triangle.numpy() >= 0
        assert hit.any() and (~hit).any()
        np.testing.assert_allclose(ph.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-5, atol=1e-6)
        jo, jpops = jtl.any_hit(jb, JT.Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist)),
                                ray_mask=jnp.asarray(m), chunks=1, count_pops=True)
        po = traverse2.traverse_plain(*args, torch.as_tensor(dist), torch.ones(n, dtype=torch.bool),
                                      torch.ones(n, dtype=torch.bool), ray_mask=torch.as_tensor(m))
        assert np.array_equal(np.asarray(jo), po.found.numpy())
        assert np.array_equal(np.asarray(jpops), po.pops.numpy())
        on_sphere.append((hit & (ph.triangle.numpy() < int(pb.flat_tri_base[1]))).sum())
    # model 0, the sphere, holds the triangles below flat_tri_base[1]: some
    # rays hit it, except under the masks that skip LIGHT geometry
    assert on_sphere[1] > 0 and (on_sphere[0] > 0) == (bits == T.RAY_MASK_PRIMARY)


@pytest.mark.parametrize("fused", [True, False])
def test_light_masked_render_matches_mrt_tpu(fused):
    """The light-masked sphere casts no shadow but stays visible; the port
    over 3 frames against mrt_tpu with fused and unfused shadow rays; then,
    as tests/test_masks.py checks, the floor is brighter than under the
    default mask, where the sphere shadows it."""
    rj = _renderer(T.GEOMETRY_MASK_LIGHT, fused=fused)
    rp = port_like(rj)
    assert rp.bvh.has_masks
    for f in range(3):
        if f:
            rj.draw()
        ap, aj = rp.draw().numpy(), np.asarray(rj.accum)
        assert int(rp.last_rays_traced) == int(rj.last_rays_traced), f"frame {f}"
        assert rel_rmse(ap, aj) < 1e-2, f"frame {f}: {rel_rmse(ap, aj)}"
    rd = port_like(_renderer(T.GEOMETRY_MASK_GEOMETRY))
    assert not rd.bvh.has_masks
    for _ in range(3):
        rd.draw()
    light_l, geom_l = ap.mean(-1), rd.accum.numpy().mean(-1)
    assert light_l.mean() > geom_l.mean()
    y, x = np.unravel_index(np.argmax(light_l - geom_l), light_l.shape)
    assert light_l[y, x] > 2.0 * geom_l[y, x] + 1e-4
    assert ap[: ap.shape[0] // 2].max() > 0.01  # the sphere, seen by camera rays


def test_default_scene_compiles_mask_free():
    """A scene with default masks: no ray masks reach the traversal."""
    rp = port_like(_renderer(T.GEOMETRY_MASK_GEOMETRY))
    assert not rp.bvh.has_masks
    seen = []
    orig = traverse2.traverse

    def spy(*a, ray_mask=None, **k):
        seen.append(ray_mask)
        return orig(*a, ray_mask=ray_mask, **k)

    traverse2.traverse = spy
    try:
        rp.draw()
    finally:
        traverse2.traverse = orig
    assert seen and all(m is None for m in seen)


def test_masks_require_twolevel_backend():
    """Switching a masked scene off the two-level backend is refused with
    mrt_tpu's ValueError; the old value stays and the renderer still draws."""
    rp = port_like(_renderer(T.GEOMETRY_MASK_LIGHT, size=16))
    with pytest.raises(ValueError, match="two-level"):
        rp.two_level = False
    assert rp.two_level is True
    assert np.isfinite(rp.draw().numpy()).all()


@pytest.mark.parametrize("n_rows", [2 ** 20 - 1, 2 ** 20 + 1], ids=["packed", "float"])
def test_sorted_candidates_match_jax(n_rows):
    """Seeded child distances with ties (t from a few values), unentered
    children (t = inf, id -1) and entered ones with any id below ``n_rows``
    (so ids above 2^20 - 1 in the float case): the port's dispatch gives
    JAX's ids nearest-first and its validity."""
    rng = np.random.default_rng(n_rows)
    r = 4096
    t = rng.choice(np.float32([0.0, 0.25, 0.5, 0.5000001, 1.0, 3.0, 7.5]), (r, 8))
    meta = rng.integers(0, n_rows, (r, 8)).astype(np.int32)
    meta[::5, 3], meta[::7, 6] = n_rows - 1, n_rows - 2  # the table's last rows
    empty = rng.random((r, 8)) < 0.3
    t = np.where(empty, np.float32(np.inf), t).astype(np.float32)
    meta = np.where(empty & (rng.random((r, 8)) < 0.5), -1, meta).astype(np.int32)
    jc, jv = jwide._sorted_candidates(jnp.asarray(t), jnp.asarray(meta), n_rows)
    pc, pv = traverse2.sorted_candidates(torch.as_tensor(t), torch.as_tensor(meta), n_rows)
    jv = np.asarray(jv)
    assert np.array_equal(jv, pv.numpy()) and 0 < jv.sum() < jv.size
    assert np.array_equal(np.asarray(jc)[jv], pc.numpy()[jv])
    assert (np.asarray(jc)[jv] > 2 ** 20 - 1).any() == (n_rows > 2 ** 20)
