"""[The benchmark's reference: a frozen copy of ``mrt_tpu_torch/core/halton.py``.]

Halton QMC sampler — bit-exact counterpart of ``mrt_tpu/core/halton.py``.

The radical inverse runs the same f32 reciprocal-floor digit loop with the
+/-1 remainder fixup, op for op, so every value equals the JAX package's
bit for bit on the CPU and on the card. Each step is its own torch op, so no
multiply-add is ever contracted into an FMA.

The per-pixel decorrelation offsets come from a seeded ``torch.Generator``
(the JAX package draws them with ``jax.random``, which torch cannot
reproduce); a ``Renderer`` also accepts offsets given from outside.
"""

from __future__ import annotations

import numpy as np
import torch

# First 100 primes.
PRIMES = np.array(
    [
        2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
        73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
        157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
        239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313, 317,
        331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409, 419,
        421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499, 503,
        509, 521, 523, 541,
    ],
    dtype=np.int32,
)

# 2^24 needs 24 base-2 digits; the f32 divide core is exact for i < 2^24.
_MAX_DIGITS = 24
RANDOM_OFFSET_MOD = 1 << 20
# Bases in the per-step schedule are >= 5 and 5^11 > 2^24.
STEP_MAX_DIGITS = 11


def halton_base(i: torch.Tensor, b, max_digits: int = _MAX_DIGITS) -> torch.Tensor:
    """Radical inverse of int32 ``i`` in (per-lane) base ``b``; indices wrap
    into [0, 2^24) like the JAX package's."""
    i = torch.as_tensor(i, dtype=torch.int32) & ((1 << 24) - 1)
    b = torch.as_tensor(b, device=i.device)
    shape = torch.broadcast_shapes(i.shape, b.shape)
    b_f = b.broadcast_to(shape).to(torch.float32)
    inv_b = torch.ones_like(b_f) / b_f
    i_f = i.broadcast_to(shape).to(torch.float32)
    f = torch.ones(shape, dtype=torch.float32, device=i.device)
    r = torch.zeros(shape, dtype=torch.float32, device=i.device)
    for _ in range(max_digits):
        q = torch.floor(i_f * inv_b)
        rem = i_f - q * b_f
        under = rem < 0.0
        q = torch.where(under, q - 1.0, q)
        rem = torch.where(under, rem + b_f, rem)
        over = rem >= b_f
        q = torch.where(over, q + 1.0, q)
        rem = torch.where(over, rem - b_f, rem)
        f = f * inv_b
        r = r + f * rem
        i_f = q
    return r


def halton(i: torch.Tensor, d) -> torch.Tensor:
    """Radical inverse of ``i`` in base ``primes[d]``."""
    i = torch.as_tensor(i, dtype=torch.int32)
    d = torch.as_tensor(d, dtype=torch.int64, device=i.device).clamp(0, 99)
    primes = torch.as_tensor(PRIMES, device=i.device)
    return halton_base(i, primes[d])


_STEP_BASE_COLS = ("light_pick", "area_a", "area_b", "transparency", "bounce_x", "bounce_y")
_STEP_BASES = np.stack(
    [
        np.array([
            PRIMES[min(2 + s * 6 + 0, 99)],
            PRIMES[min(2 + s * 6 + 1, 99)],
            PRIMES[min(2 + s * 6 + 2, 99)],
            PRIMES[min(2 + s * 6 + 5, 99)],
            PRIMES[min(2 + s * 5 + 3, 99)],
            PRIMES[min(2 + s * 5 + 4, 99)],
        ], dtype=np.int32)
        for s in range(20)
    ],
    axis=0,
)
# [bases(s) | bases(s+1)]: the glass branch advances ``step`` mid-iteration.
_STEP_BASES_PAIR = np.concatenate(
    [_STEP_BASES, _STEP_BASES[np.minimum(np.arange(20) + 1, 19)]], axis=1)


def step_bases_pair(step: torch.Tensor):
    """Per-lane bases of the six per-step dims for ``step`` and ``step+1``.
    Returns (cur, nxt) dicts keyed by ``_STEP_BASE_COLS``."""
    table = torch.as_tensor(_STEP_BASES_PAIR, device=step.device)
    rows = table[step.clamp(0, 19).long()]  # (N, 12)
    cur = {k: rows[:, j] for j, k in enumerate(_STEP_BASE_COLS)}
    nxt = {k: rows[:, 6 + j] for j, k in enumerate(_STEP_BASE_COLS)}
    return cur, nxt


def make_pixel_offsets(generator: torch.Generator, height: int, width: int) -> torch.Tensor:
    """Per-pixel Halton index offsets in [0, 2^20), drawn from ``generator``.
    Returns (H,W) int32 on the CPU."""
    return torch.randint(0, RANDOM_OFFSET_MOD, (height, width), generator=generator,
                         dtype=torch.int32)

