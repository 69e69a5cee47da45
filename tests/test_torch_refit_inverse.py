"""K5's instance inverse and the per-BVH metadata the refit kernels read
(``mrt_tpu_torch/kernels/refit.py``).

The plain ``_affine_inverse`` is the sequence of f32 operations K5 runs on
the card (Gaussian elimination with partial pivoting, then -(Rinv t)); it is
held to the JAX package's ``_affine_inverse`` (``jnp.linalg.inv``, LAPACK's
LU with partial pivoting and triangular solves) on seeded affine matrices:
rotations, nonuniform scale, shear, translation and all of them at once.
Tolerance rtol 1e-6 / atol 1e-6, the bar of the refit's instance columns in
``test_torch_refit.py``: the two compute the same pivoted elimination, but
LAPACK's blocked kernels order and round some products and sums
differently, so the last bits may differ. Against a float64 NumPy inverse,
the normwise error is held to 3 u kappa_inf(R) (n u kappa with n = 3, u
the f32 unit roundoff): the forward error a backward-stable solve of a 3x3
allows. The metadata (``Walkup.boxed``, the done count, the group index
addresses) is held to a NumPy derivation from ``node_child`` and to the
tensors it points at."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.bvh import twolevel as jtl
from mrt_tpu_torch.bvh import wide
from mrt_tpu_torch.kernels import refit
from test_torch_flat import _world_tris
from test_torch_refit import _brute, _flat_case, app  # noqa: F401
from test_torch_scene_bvh import SCENES, jax_sah, one_torch_thread  # noqa: F401

KINDS = ("rotation", "scale", "shear", "translation", "mixed")
N = 256


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], 1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], 1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1)], 1)


def _affine(kind, seed):
    """(N,4,4) f32 affine matrices of ``kind`` from ``seed``."""
    rng = np.random.default_rng(seed)
    eye = np.broadcast_to(np.eye(3), (N, 3, 3))
    rot = _rotations(rng, N) if kind in ("rotation", "mixed") else eye
    scale = (np.eye(3) * rng.uniform(0.05, 10.0, (N, 1, 3))) if kind in ("scale", "mixed") else eye
    shear = np.array(eye)
    if kind in ("shear", "mixed"):
        shear[:, 0, 1], shear[:, 0, 2], shear[:, 1, 2] = rng.uniform(-0.8, 0.8, (3, N))
    M = np.zeros((N, 4, 4), np.float32)
    M[:, :3, :3] = rot @ shear @ scale
    if kind in ("translation", "mixed"):
        M[:, :3, 3] = rng.uniform(-5.0, 5.0, (N, 3))
    M[:, 3, 3] = 1.0
    return M


@pytest.mark.parametrize("kind", KINDS)
def test_affine_inverse_matches_jax(kind):
    """The plain ``_affine_inverse`` (K5's sequence) against the JAX
    package's on the same seeded matrices, rtol 1e-6 / atol 1e-6."""
    M = _affine(kind, KINDS.index(kind) + 51)
    got = refit._affine_inverse(torch.as_tensor(M)).numpy()
    want = np.asarray(jtl._affine_inverse(jnp.asarray(M)))
    assert got.shape == want.shape == (N, 3, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_affine_inverse_float64(kind):
    """The same against float64 NumPy: every matrix's normwise error within
    3 u kappa_inf(R); the identity and the translation column exactly where
    the matrix is a pure translation."""
    M = _affine(kind, KINDS.index(kind) + 61)
    got = refit._affine_inverse(torch.as_tensor(M)).numpy().astype(np.float64)
    M64 = M.astype(np.float64)
    want = np.linalg.inv(M64)[:, :3, :]
    err = np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
    kappa = np.linalg.cond(M64[:, :3, :3], np.inf)
    assert (err <= 3 * np.finfo(np.float32).eps * kappa).all(), float((err / kappa).max())
    if kind == "translation":
        assert np.array_equal(got[:, :, :3], np.broadcast_to(np.eye(3), (N, 3, 3)))
        assert np.array_equal(got[:, :, 3], -M64[:, :3, 3])


def test_inverse_pivots_and_ties():
    """The pivot rows: a zero leading entry (a swap is needed), ties (the
    first row wins, as K5's strict comparisons), a permutation, a negative
    scale; each against float64 within 3 u kappa."""
    cases = np.array([
        [[0, 1, 0], [1, 0, 0], [0, 0, 1]],
        [[0, 0, 2], [0, 3, 0], [4, 0, 0]],
        [[1, 2, 3], [-1, 2, 3], [1, -2, 3]],
        [[2, 1, 1], [2, -1, 1], [2, 1, -1]],
        [[-0.5, 0, 0], [0, 2, 0], [0, 0, -8]],
        [[1e-3, 1, 0], [1, 1e-3, 0], [0, 1, 1]],
    ], np.float64)
    M = np.zeros((len(cases), 4, 4), np.float32)
    M[:, :3, :3] = cases
    M[:, :3, 3] = [1.0, -2.0, 0.5]
    M[:, 3, 3] = 1.0
    got = refit._affine_inverse(torch.as_tensor(M)).numpy().astype(np.float64)
    want = np.linalg.inv(M.astype(np.float64))[:, :3, :]
    kappa = np.linalg.cond(cases, np.inf)
    err = np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
    assert (err <= 3 * np.finfo(np.float32).eps * kappa).all(), err
    np.testing.assert_allclose(got, np.asarray(jtl._affine_inverse(jnp.asarray(M))), rtol=1e-6,
                               atol=1e-6)


def _boxed_numpy(child, n_leaf):
    """Per internal row, bit j set where child j holds a box: a leaf entry,
    or an internal row that a leaf reaches (``_brute``'s need > 0)."""
    ni = child.shape[0]
    _, need = _brute(child, n_leaf)
    out = np.zeros(ni, np.int64)
    for r in range(ni):
        for j, c in enumerate(child[r]):
            if 0 <= c < ni + n_leaf and (c >= ni or need[c] > 0):
                out[r] |= 1 << j
    return out


def _synthetic_tree(rng, ni=60, n_leaf=90):
    """A seeded (ni, ARITY) ``node_child`` whose rows hang from row 0, with
    leaves on some rows only: whole subtrees no leaf reaches, below rows a
    leaf does reach (a mask that marked every child would show)."""
    child = np.full((ni, 8), -1, np.int32)
    fill = np.zeros(ni, int)
    for r in range(1, ni):
        p = int(rng.choice([q for q in range(r) if fill[q] < 8]))
        child[p, fill[p]] = r
        fill[p] += 1
    bare = rng.random(ni) < 0.4  # rows that take no leaf
    for leaf in range(n_leaf):
        p = int(rng.choice([q for q in range(ni) if fill[q] < 8 and not bare[q]]))
        child[p, fill[p]] = ni + leaf
        fill[p] += 1
    return child


BOXED_CASES = ("flat", "padded_shard", "twolevel", "synthetic")


@pytest.mark.parametrize("case", BOXED_CASES)
def test_walkup_boxed_mask(case, app):  # noqa: F811
    """``Walkup.boxed`` (the children whose boxes K4 reads) against a NumPy
    derivation from ``node_child``, and its popcount equal to ``need``: a
    flat table, every shard of a padded gp split, the app scene's two-level
    BVH (its BLAS rows; the TLAS's children are instances) and a seeded
    tree with unreached subtrees under reached rows."""
    if case == "synthetic":
        child = _synthetic_tree(np.random.default_rng(81))
        wu = refit.flat_walkup(child, 90, "cpu")
        _, need = _brute(child, 90)
        assert ((need == 0) & (np.arange(60) > 0)).any()  # an unreached row with a parent
        walks = [(child, 90, wu)]
    elif case == "flat":
        pbs = [wide.build(*_world_tris(SCENES["config3"]()), device="cpu")]
        walks = [(pb.node_child.numpy(), pb.leaf_tri.shape[0], pb.walkup) for pb in pbs]
    elif case == "padded_shard":
        shards = [pb for _, pb, _, _ in _flat_case("padded_shard", np.random.default_rng(71))]
        walks = [(pb.node_child.numpy(), pb.leaf_tri.shape[0], pb.walkup) for pb in shards]
    else:
        pb = app["pb"]
        walks = [(pb.node_child.numpy(), pb.n_leaf, pb.refit_meta.walkup)]
    for child, n_leaf, wu in walks:
        boxed = wu.boxed.numpy()
        assert wu.boxed.dtype == torch.uint8 and boxed.shape == (child.shape[0],)
        want = _boxed_numpy(child, n_leaf)
        rows = slice(app["pb"].tlas_n, None) if case == "twolevel" else slice(None)
        assert np.array_equal(boxed[rows].astype(np.int64), want[rows])
        popcount = np.unpackbits(boxed[:, None], axis=1).sum(axis=1)
        assert np.array_equal(popcount[rows], wu.need.numpy()[rows])


def test_twolevel_meta_done_and_index_addresses(app):  # noqa: F811
    """The done count K5's block is elected by: one int32, 0 where the BVH
    is made; each skinned group's index address the first triple of its
    indices in ``skin_tris`` (0 for a static group), made again for the
    copy's storage by ``TwoLevelMeta.to``."""
    pb = app["pb"]
    for meta in (pb.refit_meta, pb.refit_meta.to("cpu")):
        assert meta.done.dtype == torch.int32 and meta.done.tolist() == [0]
        assert meta.skin_tris.dtype == torch.int32 and meta.skin_tris.is_contiguous()
        toff = meta.skin_toff.tolist()
        at = meta.skin_tris_at.tolist()
        assert meta.skin_tris_at.dtype == torch.int64 and len(at) == len(pb.mesh_meta)
        for g, m in enumerate(pb.mesh_meta):
            if m[8] < 0:
                assert toff[g] == -1 and at[g] == 0
                continue
            assert at[g] == meta.skin_tris.data_ptr() + 12 * toff[g]
            n = pb.skin_indices[m[8]].shape[0]
            assert torch.equal(meta.skin_tris[toff[g]:toff[g] + n], pb.skin_indices[m[8]].to(torch.int32))
    assert sum(m[8] >= 0 for m in pb.mesh_meta) >= 1
