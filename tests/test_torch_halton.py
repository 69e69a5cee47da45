"""Halton parity between mrt_tpu_torch and mrt_tpu: bit-exact radical
inverses over the base/boundary sweep of tests/test_halton.py, the per-step
base table and the dimension schedule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt_tpu.core import halton as JH
from mrt_tpu_torch.core import halton as H


def _sweep(d: int, rng) -> np.ndarray:
    """Indices on and next to quotient boundaries of base primes[d], dense
    low ones and random high ones, all below 2^24."""
    b = int(H.PRIMES[d])
    ks = np.unique(rng.integers(1, (1 << 24) // b, size=64))
    i = np.unique(np.concatenate([ks * b - 1, ks * b, ks * b + 1, np.arange(0, 4096, 97),
                                  rng.integers(1 << 20, 1 << 24, size=64)]))
    return i[(i >= 0) & (i < (1 << 24))].astype(np.int32)


@pytest.mark.parametrize("d_lo", [0, 25, 50, 75])
def test_halton_bit_exact_sweep(d_lo):
    """halton(i, d) equals the JAX package's bit for bit, and the scalar
    oracle, for every base of the slice (tolerance: none)."""
    rng = np.random.default_rng(7 + d_lo)
    for d in range(d_lo, d_lo + 25):
        i = _sweep(d, rng)
        got = H.halton(torch.as_tensor(i), d).numpy()
        want = np.asarray(JH.halton(jnp.asarray(i), jnp.full(i.shape, d, jnp.int32)))
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), f"base {H.PRIMES[d]}"
        oracle = np.array([JH.halton_np(int(v), d) for v in i[::7]], np.float32)
        assert np.array_equal(got[::7], oracle)


def test_halton_base_step_digits_bit_exact():
    """The 11-digit per-step budget (bases >= 5) is bit-equal too."""
    rng = np.random.default_rng(11)
    i = rng.integers(0, 1 << 24, size=4096).astype(np.int32)
    b = H.PRIMES[rng.integers(2, 100, size=4096)]
    got = H.halton_base(torch.as_tensor(i), torch.as_tensor(b), H.STEP_MAX_DIGITS).numpy()
    want = np.asarray(JH.halton_base(jnp.asarray(i), jnp.asarray(b), JH.STEP_MAX_DIGITS))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_index_wraps_like_jax():
    i = np.array([0, 1, (1 << 24) - 1, 1 << 24, (1 << 24) + 5, (1 << 31) - 1], np.int32)
    got = H.halton(torch.as_tensor(i), 3).numpy()
    want = np.asarray(JH.halton(jnp.asarray(i), jnp.full(i.shape, 3, jnp.int32)))
    assert np.array_equal(got, want)


def test_step_bases_pair_matches():
    step = np.array([0, 1, 2, 5, 18, 19, 20, 40], np.int32)
    cur, nxt = H.step_bases_pair(torch.as_tensor(step))
    jcur, jnxt = JH.step_bases_pair(jnp.asarray(step))
    for k in H._STEP_BASE_COLS:
        assert np.array_equal(cur[k].numpy(), np.asarray(jcur[k]))
        assert np.array_equal(nxt[k].numpy(), np.asarray(jnxt[k]))


def test_dimension_schedule_and_constants():
    assert np.array_equal(H.PRIMES, JH.PRIMES)
    assert (H.STEP_MAX_DIGITS, H._MAX_DIGITS, H.RANDOM_OFFSET_MOD) == (
        JH.STEP_MAX_DIGITS, JH._MAX_DIGITS, JH.RANDOM_OFFSET_MOD)
    for s in (0, 3, 7):
        assert H.dim_light_pick(s) == int(JH.dim_light_pick(jnp.asarray(s)))
        assert H.dim_area_sample(s) == tuple(int(x) for x in JH.dim_area_sample(jnp.asarray(s)))
        assert H.dim_transparency(s) == int(JH.dim_transparency(jnp.asarray(s)))
        assert H.dim_bounce(s) == tuple(int(x) for x in JH.dim_bounce(jnp.asarray(s)))
    assert H.dim_aa() == JH.dim_aa()


def test_pixel_offsets_seeded_generator():
    a = H.make_pixel_offsets(torch.Generator().manual_seed(4), 16, 32)
    b = H.make_pixel_offsets(torch.Generator().manual_seed(4), 16, 32)
    assert a.shape == (16, 32) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < H.RANDOM_OFFSET_MOD
