"""K3's plain version on the tie scene against live mrt_tpu, the float
child sort's network as stages of disjoint pairs (what a kernel that sorts
a ray's children across lanes would apply, a stage a shuffle), the SIMT
share and occupancy readings (``utils/bounds.py``) and ``k2_compare``'s K3
summaries.

Tolerances: on the tie scene (``utils/tie_scene.py``: every product of the
leaf and slab tests exact, so XLA:CPU's fused multiply-adds round as
separate operations do) ``traverse_flat_plain`` is bit-equal to the JAX
package's ``_traverse_flat_rows`` in t, u and v but for the sign of a zero
(the JAX package picks the nearest slot's t, u, v by a masked sum, which
turns -0.0 into +0.0; the plain version and the kernel keep the slot's own
bits), and equal in triangle, occlusion and per-lane pops, with the packed
key and with the float child sort. Everything else is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.bvh import wide as jwide
from mrt_tpu.core.types import Rays as JRays
from mrt_tpu_torch.bvh import intersect, wide
from mrt_tpu_torch.kernels import traverse2
from mrt_tpu_torch.utils import bounds, k2_compare, tie_scene
from test_torch_scene_bvh import jax_sah, one_torch_thread  # noqa: F401

R = 4096


@pytest.fixture(scope="module")
def ties():
    """The tie scene's flat tables from both packages (SAH, same
    triangles) and its rays."""
    v0, v1, v2, rays = tie_scene.tie_scene(seed=0, count=R)
    with jax_sah():
        jb = jwide.build(v0, v1, v2, method="sah")
    pb = wide.build(v0, v1, v2, method="sah", device="cpu")
    return dict(tris=(v0, v1, v2), jb=jb, pb=pb, rays=rays)


def _plus_zero_bits(x):
    """float32 bits with -0.0 read as +0.0 (adding +0.0 does that)."""
    return (np.asarray(x, np.float32) + np.float32(0.0)).view(np.int32)


@pytest.mark.parametrize("sort", ["packed", "float"])
def test_tie_scene_plain_matches_jax(ties, sort, monkeypatch):
    """traverse_flat_plain bit-equal (but for a zero's sign) and pop-equal
    to the JAX package's flat loop on the tie scene, closest and shadow
    rays mixed, with each child sort; the scene does tie: rays whose
    nearest t two triangles share, internal rows with two entered children
    at one t, hits at t == tmax and at t = 0, and u or v of -0.0."""
    o, d, tmax, shadow, active = ties["rays"]
    if sort == "float":
        monkeypatch.setattr(jwide, "_META_MASK", 1)
        monkeypatch.setattr(traverse2, "_META_MASK", 1)
    pb = ties["pb"]
    assert traverse2.flat_variant(pb.n_rows) == ("flat" if sort == "packed" else "flat_float_sort")
    child_ties = []
    orig_sort = traverse2.sorted_candidates

    def spy(tA, meta, n_rows):
        fin = torch.where(torch.isfinite(tA), tA, torch.nan)
        s = fin.sort(dim=1).values
        child_ties.append(int(((s[:, 1:] == s[:, :-1])).any(dim=1).sum()))
        return orig_sort(tA, meta, n_rows)

    monkeypatch.setattr(traverse2, "sorted_candidates", spy)
    p = traverse2.traverse_flat_plain(pb.table, pb.n_internal, pb.stack_size,
                                      *(torch.as_tensor(x) for x in (o, d, tmax, shadow, active)))
    j = jwide._traverse_flat_rows(ties["jb"], JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)),
                                  0.0, jnp.asarray(active), jnp.asarray(shadow), count_pops=True)
    for f, jf in (("t", "best_t"), ("u", "best_u"), ("v", "best_v")):
        assert np.array_equal(_plus_zero_bits(getattr(p, f).numpy()), _plus_zero_bits(j[jf])), f
    assert np.array_equal(p.tri.numpy(), np.asarray(j["best_tri"]))
    assert np.array_equal(p.found.numpy(), np.asarray(j["found"]))
    assert np.array_equal(p.pops.numpy(), np.asarray(j["pops"]))
    # the ties happen
    hit = p.tri.numpy() >= 0
    assert 0.3 * R < hit.sum() < R and (p.found.numpy() & shadow).sum() > 0
    assert sum(child_ties) > 100
    neg_zero = lambda x: (x.numpy().view(np.int32) == np.int32(-2 ** 31)) & hit  # noqa: E731
    assert neg_zero(p.u).sum() + neg_zero(p.v).sum() > 0
    # a hit at exactly t == tmax: occluded, but not nearer than tmax
    assert (p.found.numpy() & ~hit & active).sum() > 0 and (hit & (p.t.numpy() == 0.0)).sum() > 0
    v0, v1, v2 = (torch.as_tensor(v)[None] for v in ties["tris"])
    lanes = np.nonzero(hit & ~shadow)[0]
    h, t, _, _ = intersect.ray_triangle(torch.as_tensor(o[lanes])[:, None],
                                        torch.as_tensor(d[lanes])[:, None], v0, v1, v2)
    t = torch.where(h, t, torch.inf)
    nearest = t.min(dim=1, keepdim=True).values
    assert int(((t == nearest).sum(dim=1) >= 2).sum()) > 100


def _stages():
    return [traverse2.SORT_PAIRS[k:k + 4] for k in range(0, len(traverse2.SORT_PAIRS), 4)]


def test_sort_pairs_are_six_stages_of_disjoint_pairs():
    """SORT_PAIRS (the JAX package's _bitonic_pairs(8)) is 6 stages of 4
    disjoint pairs covering the 8 slots, in bitonic (k, j) order: slot c's
    partner is c ^ j, and c is the pair's first element (the one that takes
    the smaller t) exactly where ``(c & k == 0) == (c & j == 0)``."""
    assert traverse2.SORT_PAIRS == jwide._bitonic_pairs(8)
    stages = _stages()
    assert len(traverse2.SORT_PAIRS) == 24 and len(stages) == 6
    kj = [(k, j) for k in (2, 4, 8) for j in (k // 2, k // 4, k // 8) if j >= 1]
    assert len(kj) == 6
    for stage, (k, j) in zip(stages, kj):
        slots = [s for pair in stage for s in pair]
        assert sorted(slots) == list(range(8))
        for a, b in stage:
            assert a ^ b == j
            for c in (a, b):
                first = ((c & k) == 0) == ((c & j) == 0)
                assert first == (c == a), (stage, c)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_sort_stages_equal_the_sequential_network(kind):
    """Each stage of SORT_PAIRS applied at once (every slot reads the
    stage's inputs, as lanes would through one shuffle) equals the
    pairs applied one after another, ids and t, on random t and on t with
    many ties (equal values, inf) and -0.0."""
    rng = np.random.default_rng(3)
    n = 4096
    if kind == "random":
        t = rng.random((n, 8)).astype(np.float32)
        t[rng.random((n, 8)) < 0.3] = np.inf
    else:
        t = rng.choice(np.float32([0.0, -0.0, 0.5, 0.5, 1.0, np.inf]), (n, 8)).astype(np.float32)
    ids = np.tile(np.arange(8, dtype=np.int32), (n, 1))
    seq_t, seq_i = t.copy(), ids.copy()
    for a, b in traverse2.SORT_PAIRS:
        swap = seq_t[:, a] > seq_t[:, b]
        ta, tb = seq_t[:, a].copy(), seq_t[:, b].copy()
        ia, ib = seq_i[:, a].copy(), seq_i[:, b].copy()
        seq_t[:, a], seq_t[:, b] = np.where(swap, tb, ta), np.where(swap, ta, tb)
        seq_i[:, a], seq_i[:, b] = np.where(swap, ib, ia), np.where(swap, ia, ib)
    st_t, st_i = t.copy(), ids.copy()
    for stage in _stages():
        new_t, new_i = st_t.copy(), st_i.copy()
        for a, b in stage:
            swap = st_t[:, a] > st_t[:, b]  # both lanes of the pair test t[a] > t[b]
            new_t[:, a] = np.where(swap, st_t[:, b], st_t[:, a])
            new_t[:, b] = np.where(swap, st_t[:, a], st_t[:, b])
            new_i[:, a] = np.where(swap, st_i[:, b], st_i[:, a])
            new_i[:, b] = np.where(swap, st_i[:, a], st_i[:, b])
        st_t, st_i = new_t, new_i
    assert np.array_equal(st_t.view(np.int32), seq_t.view(np.int32))
    assert np.array_equal(st_i, seq_i)
    assert np.all(st_t[:, 1:] >= st_t[:, :-1])
    # the plain version's float sort is the same network
    pc, pv = traverse2.sorted_candidates(torch.as_tensor(t), torch.as_tensor(ids), 2 ** 21)
    assert np.array_equal(pc.numpy(), seq_i) and np.array_equal(pv.numpy(), np.isfinite(seq_t))


@pytest.mark.parametrize("group, work, steps", [(1, 30, 30), (2, 30, 32), (4, 30, 36), (8, 30, 40),
                                                (32, 30, 160)])
def test_lane_steps_and_simt_share_on_hand_made_pops(group, work, steps):
    """Pops 1, 2, 3, 4, (dead), 5, 5, 5, 5: the live list is 8 lanes; each
    run of ``group`` waits for its largest pops, the last run padded."""
    pops = torch.tensor([1, 2, 3, 4, 9, 5, 5, 5, 5], dtype=torch.int32)
    live = torch.tensor([1, 1, 1, 1, 0, 1, 1, 1, 1], dtype=torch.bool)
    assert bounds.lane_steps(pops, live, group) == (work, steps)
    assert bounds.simt_share(pops, live, group) == pytest.approx(work / steps)


def test_simt_share_edges():
    """One ray working: 1/group of the lane-steps do work, alone or beside
    rays that pop nothing; a group of one always works; no live lane
    gives 1.0."""
    one = torch.tensor([7] + [0] * 31, dtype=torch.int32)
    assert bounds.simt_share(one, one > 0, 32) == pytest.approx(1 / 32)
    assert bounds.simt_share(one, torch.ones(32, dtype=torch.bool), 8) == pytest.approx(7 / 56)
    assert bounds.simt_share(one, torch.ones(32, dtype=torch.bool), 1) == 1.0
    assert bounds.simt_share(one, torch.zeros(32, dtype=torch.bool), 8) == 1.0


@pytest.mark.parametrize("registers, threads, shared, blocks", [
    (92, 128, 0, 5),  # K3 as K2's kernel under FLAT: 20 warps an SM
    (95, 128, 0, 5),
    (64, 128, 8256, 8),  # 32 warps
    (48, 128, 8256, 10),
    (32, 128, 8256, 16),
    (16, 128, 0, 16),  # the SM's 64 warps
    (40, 128, 60000, 3),  # shared memory binds
    (16, 32, 0, 32)])  # the SM's 32 blocks
def test_blocks_per_sm(registers, threads, shared, blocks):
    assert bounds.blocks_per_sm(registers, threads, shared) == blocks


def test_k3_summaries(tmp_path):
    """k2_compare's K3 pieces: resources by instantiation (K2's own
    instantiations left out), and the SIMT shares of a k3_profile pops file
    summed over a case's launches."""
    res = k2_compare.k3_resources({
        "_Z16traverse2_kernelILb0ELb0ELb1EEvPK6float4iiii": dict(registers=92, stack=512),
        "_Z16traverse2_kernelILb0ELb0ELb0EEvPK6float4iiii": dict(registers=95, stack=512),
        "_Z16traverse2_kernelILb0ELb1ELb1EEvPK6float4iiii": dict(registers=64, smem=8256,
                                                                    stack=0)})
    assert res == {"flat": dict(registers=92, stack=512, threads=128, blocks_per_sm=5,
                                warps_per_sm=20),
                   "flat_float_sort": dict(registers=64, smem=8256, stack=0, threads=128,
                                           blocks_per_sm=8, warps_per_sm=32)}
    f = tmp_path / "pops.npz"
    np.savez_compressed(f, **{"J/0": np.array([1, 2, 3, 4, 5, 5, 5, 5], np.int16),
                              "J/1": np.array([7], np.int16), "rays/0": np.ones(64, np.int16)})
    got = k2_compare.k3_shares(str(f))
    assert got["rays"] == dict(launches=1, live=64, pops=64, simt_share={32: 1.0, 8: 1.0, 4: 1.0})
    assert got["J"]["launches"] == 2 and got["J"]["live"] == 9 and got["J"]["pops"] == 37
    assert got["J"]["simt_share"] == {32: 37 / (32 * 5 + 32 * 7), 8: 37 / (8 * 5 + 8 * 7),
                                      4: 37 / (4 * 4 + 4 * 5 + 4 * 7)}

