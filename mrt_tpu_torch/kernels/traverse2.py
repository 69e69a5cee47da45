"""Kernel K2 — two-level wide-BVH traversal (``csrc/traverse2.cu``), its
wrapper and its plain PyTorch version.

Replaces ``mrt_tpu/bvh/twolevel.py:_step2`` (looped by ``_traverse2``). The
wrapper launches the CUDA kernels for CUDA tensors (a compaction of the live
lanes, then a persistent traversal over them) and takes the plain version
only for CPU tensors. The plain version is a lane-vector transcription of
``_step2``: pop, one row gather, then per row type the instance switch (with
the geometry-mask test when ray masks are given), the 12-wide
Moller-Trumbore or the 8 slab tests with the sorted push, in a Python loop
until no lane is left. Children sort by the packed [t-bits | id] key on
tables of at most 2^20 - 1 rows and by float t carrying the id above that
(``sorted_candidates``, the JAX package's dispatch). The kernel has one
instantiation per (masked, float sort) pair, so an unmasked scene's small
table runs the same code as before either existed. It keeps only the lanes that still
have stack entries each step, and writes each three-term dot product as
explicit adds in the JAX order, so its t/u/v are bit-equal to the kernel's.
Both count the rows each lane popped (the JAX package's ``count_pops``); the
plain version also counts the pops of each table row and the rays that
entered each instance row, from which ``utils/bounds.py`` gives the least
time the card could take.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..bvh.wide import ARITY, IDS_OFF, LEAF_K, META_OFF, _KEY_MAX, _META_BITS, _META_MASK, \
    decode_ids

MAX_STACK = 128  # the kernel's compile-time stack cap (csrc/traverse2.cu)
# the kernel's instantiations: (masked, float sort) -> name
VARIANTS = {(False, False): "packed", (True, False): "masked", (False, True): "float_sort",
            (True, True): "masked_float_sort"}
launches = 0  # kernel launches by ``traverse`` in this process
variant_launches = dict.fromkeys(VARIANTS.values(), 0)  # the same, by instantiation

_I_WBMIN, _I_WBMAX, _I_ROOT, _I_ID, _I_MASK = 12, 15, 18, 19, 20


def variant(n_rows: int, masked: bool) -> str:
    """The kernel instantiation a table of ``n_rows`` rows and rays with or
    without masks take."""
    return VARIANTS[(masked, n_rows > _META_MASK)]


def reset_launches():
    """Set every launch count to 0."""
    global launches
    launches = 0
    for k in variant_launches:
        variant_launches[k] = 0


def _bitonic_pairs(n: int):
    """Compare-exchange pairs of a bitonic sorting network for pow2 ``n``,
    in the JAX package's order (``wide._bitonic_pairs``)."""
    pairs = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            for i in range(n):
                partner = i ^ j
                if partner > i:
                    pairs.append((i, partner) if (i & k) == 0 else (partner, i))
            j //= 2
        k *= 2
    return pairs


SORT_PAIRS = _bitonic_pairs(ARITY)  # ARITY is a power of two


def sorted_candidates(tA, meta, n_rows: int):
    """Children nearest-first: (ids (R, ARITY) int32, valid (R, ARITY) bool)
    from the child entry distances ``tA`` (inf where not entered) and ids
    ``meta`` (-1 where empty), as ``wide._sorted_candidates`` orders them.
    Tables of at most 2^20 - 1 rows sort one packed int32 key [t-bits >> 20
    | id]; larger ones sort t (a float) with the bitonic network, swapping
    on ``t[a] > t[b]`` and carrying the id."""
    if n_rows <= _META_MASK:
        ok = torch.isfinite(tA) & (meta >= 0)
        key = ((tA.contiguous().view(torch.int32) >> _META_BITS) << _META_BITS) | (meta & _META_MASK)
        keys = torch.sort(torch.where(ok, key, _KEY_MAX), dim=1).values
        return keys & _META_MASK, keys != _KEY_MAX
    t = list(tA.unbind(1))
    m = list(meta.unbind(1))
    for a, b in SORT_PAIRS:
        swap = t[a] > t[b]
        t[a], t[b] = torch.where(swap, t[b], t[a]), torch.where(swap, t[a], t[b])
        m[a], m[b] = torch.where(swap, m[b], m[a]), torch.where(swap, m[a], m[b])
    return torch.stack(m, dim=1), torch.isfinite(torch.stack(t, dim=1))


class TraverseOut(NamedTuple):
    t: torch.Tensor  # (R,) f32 best t (max_distance when nothing was hit)
    tri: torch.Tensor  # (R,) int32 LOCAL triangle id, -1 = none
    inst: torch.Tensor  # (R,) int32 instance id, -1 = none
    u: torch.Tensor  # (R,) f32
    v: torch.Tensor  # (R,) f32
    found: torch.Tensor  # (R,) bool any hit within max_distance
    pops: torch.Tensor  # (R,) int32 rows popped (0 for inactive lanes)
    # (table rows, 2) int64 from the plain version (None from the kernel):
    # the pops of each row, and the rays that entered each instance row
    visits: torch.Tensor | None = None


def _guarded_inv(d):
    tiny = torch.where(d < 0, -1e-12, 1e-12).to(d.dtype)
    g = torch.where(d.abs() < 1e-12, tiny, d)
    return torch.ones_like(g) / g


def _affine(m, p, translate: bool):
    """(m,12) packed 3x4 rows applied to (m,3) points/directions."""
    out = []
    for r in range(3):
        x = m[:, 4 * r] * p[:, 0] + m[:, 4 * r + 1] * p[:, 1] + m[:, 4 * r + 2] * p[:, 2]
        if translate:
            x = x + m[:, 4 * r + 3]
        out.append(x)
    return torch.stack(out, dim=1)


def _slab3(lo, hi, o, inv):
    """min/max of the per-axis slab intervals; lo/hi/o/inv are lists of 3."""
    t0 = [(lo[a] - o[a]) * inv[a] for a in range(3)]
    t1 = [(hi[a] - o[a]) * inv[a] for a in range(3)]
    mn = [torch.minimum(t0[a], t1[a]) for a in range(3)]
    mx = [torch.maximum(t0[a], t1[a]) for a in range(3)]
    tn = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    tf = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    return tn, tf


def traverse_plain(table, n_internal: int, n_leaf: int, tlas_n: int, stack_size: int,
                   origin, direction, tmax, shadow, active, t_min: float = 0.0,
                   ray_mask=None) -> TraverseOut:
    """Plain PyTorch two-level traversal (any device), with per-lane pops and
    per-row visits (``TraverseOut.visits``)."""
    R = origin.shape[0]
    dev = origin.device
    S = stack_size
    best_t = tmax.clone()
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(R, dtype=torch.float32, device=dev)
    best_v = torch.zeros(R, dtype=torch.float32, device=dev)
    found = torch.zeros(R, dtype=torch.bool, device=dev)
    o = origin.clone()
    d = direction.clone()
    cur_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((R, S), dtype=torch.int32, device=dev)
    sp = active.to(torch.int32)
    pops = torch.zeros(R, dtype=torch.int32, device=dev)
    visits = torch.zeros((table.shape[0], 2), dtype=torch.int64, device=dev)
    inst_base = n_internal + n_leaf
    inf = float("inf")
    kpos = torch.arange(ARITY, device=dev)

    lanes = torch.nonzero(sp > 0).squeeze(1)
    while lanes.numel():
        spl = sp[lanes] - 1
        entry = stack[lanes, spl.long()]
        sp[lanes] = spl
        pops[lanes] += 1
        e = entry.long()
        visits[:, 0].index_add_(0, e, torch.ones_like(e))
        row = table[e]
        t_cap = best_t[lanes]
        is_inst = entry >= inst_base
        is_leaf = (entry >= n_internal) & ~is_inst
        is_int = ~is_leaf & ~is_inst

        # --- instance rows ------------------------------------------------------
        if bool(is_inst.any()):
            L, r = lanes[is_inst], row[is_inst]
            wo, wd = origin[L], direction[L]
            inv = _guarded_inv(wd)
            tn, tf = _slab3([r[:, _I_WBMIN + a] for a in range(3)],
                            [r[:, _I_WBMAX + a] for a in range(3)],
                            [wo[:, a] for a in range(3)], [inv[:, a] for a in range(3)])
            hit = (tn <= tf) & (tf >= 0.0) & (tn <= t_cap[is_inst])
            if ray_mask is not None:
                hit = hit & ((decode_ids(r[:, _I_MASK]) & ray_mask[L]) != 0)
            eh = e[is_inst][hit]
            visits[:, 1].index_add_(0, eh, torch.ones_like(eh))
            H, rh = L[hit], r[hit]
            o[H] = _affine(rh[:, 0:12], origin[H], True)
            d[H] = _affine(rh[:, 0:12], direction[H], False)
            cur_inst[H] = decode_ids(rh[:, _I_ID])
            sph = sp[H]
            room = sph < S
            stack[H[room], sph[room].long()] = decode_ids(rh[room, _I_ROOT])
            sp[H] = torch.clamp(sph + 1, max=S)

        # --- leaf rows: LEAF_K-wide Moller-Trumbore --------------------------------
        if bool(is_leaf.any()):
            L, r = lanes[is_leaf], row[is_leaf]
            K = LEAF_K
            ox, oy, oz = (o[L, a:a + 1] for a in range(3))
            dx, dy, dz = (d[L, a:a + 1] for a in range(3))
            v0x, v0y, v0z = r[:, 0:K], r[:, K:2 * K], r[:, 2 * K:3 * K]
            v1x, v1y, v1z = r[:, 3 * K:4 * K], r[:, 4 * K:5 * K], r[:, 5 * K:6 * K]
            v2x, v2y, v2z = r[:, 6 * K:7 * K], r[:, 7 * K:8 * K], r[:, 8 * K:9 * K]
            e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
            e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            valid = det.abs() > 1e-9
            inv = torch.where(valid, torch.ones_like(det) / torch.where(valid, det, 1.0), 0.0)
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv
            t = (e2x * qx + e2y * qy + e2z * qz) * inv
            tc = t_cap[is_leaf][:, None]
            hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) & (t <= tc)
            t_m = torch.where(hit, t, inf)
            jb = torch.argmin(t_m, dim=1, keepdim=True)
            cand_t = t_m.gather(1, jb)[:, 0]
            cand_any = hit.any(dim=1)
            take = cand_any & (cand_t < best_t[L])
            T, jt = L[take], jb[take]
            best_t[T] = cand_t[take]
            best_tri[T] = decode_ids(r[take, IDS_OFF:IDS_OFF + K]).gather(1, jt)[:, 0]
            best_inst[T] = cur_inst[T]
            best_u[T] = u[take].gather(1, jt)[:, 0]
            best_v[T] = v[take].gather(1, jt)[:, 0]
            found[L] = found[L] | cand_any
            sp[L] = torch.where(found[L] & shadow[L], 0, sp[L])

        # --- internal rows: ARITY child slabs + nearest-first push -----------------
        if bool(is_int.any()):
            L, r = lanes[is_int], row[is_int]
            tl = (entry[is_int] < tlas_n)[:, None]
            po = torch.where(tl, origin[L], o[L])
            inv = _guarded_inv(torch.where(tl, direction[L], d[L]))
            A = ARITY
            tnear, tfar = _slab3([r[:, a * A:(a + 1) * A] for a in range(3)],
                                 [r[:, (3 + a) * A:(4 + a) * A] for a in range(3)],
                                 [po[:, a:a + 1] for a in range(3)],
                                 [inv[:, a:a + 1] for a in range(3)])
            hit = (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_cap[is_int][:, None])
            a_t = torch.where(tnear > 0.0, tnear, 0.0)
            meta = decode_ids(r[:, META_OFF:META_OFF + A])
            t_a = torch.where(hit & (meta >= 0), a_t, inf)
            cands, valid = sorted_candidates(t_a, meta, table.shape[0])
            n_push = valid.sum(dim=1).to(torch.int32)
            spi = sp[L]
            pos = spi[:, None] + (n_push[:, None] - 1 - kpos[None, :])
            write = (kpos[None, :] < n_push[:, None]) & (pos < S)
            rows_w = L[:, None].expand(-1, A)[write]
            stack[rows_w, pos[write].long()] = cands[write]
            sp[L] = torch.clamp(spi + n_push, max=S)

        lanes = lanes[sp[lanes] > 0]
    return TraverseOut(best_t, best_tri, best_inst, best_u, best_v, found, pops, visits)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"traverse: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"traverse: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"traverse: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"traverse: {name} is not contiguous")


def traverse(table, n_internal: int, n_leaf: int, tlas_n: int, stack_size: int,
             origin, direction, tmax, shadow, active, t_min: float = 0.0,
             ray_mask=None) -> TraverseOut:
    """Trace (R,) rays through the two-level table. ``shadow`` lanes stop at
    their first hit; lanes with ``active`` False return the miss record;
    ``ray_mask`` (optional, (R,) int32) skips the instances whose geometry
    mask shares no bit with the ray's. CPU tensors take the plain version;
    CUDA tensors launch the kernels."""
    global launches
    if origin.device.type == "cpu":
        return traverse_plain(table, n_internal, n_leaf, tlas_n, stack_size, origin, direction,
                              tmax, shadow, active, t_min, ray_mask)
    if origin.device.type != "cuda":
        raise ValueError(f"traverse: unsupported device {origin.device}")
    R = origin.shape[0]
    dev = origin.device
    _check("table", table, torch.float32, (table.shape[0], 128), dev)
    _check("origin", origin, torch.float32, (R, 3), dev)
    _check("direction", direction, torch.float32, (R, 3), dev)
    _check("tmax", tmax, torch.float32, (R,), dev)
    _check("shadow", shadow, torch.bool, (R,), dev)
    _check("active", active, torch.bool, (R,), dev)
    if ray_mask is not None:
        _check("ray_mask", ray_mask, torch.int32, (R,), dev)
    if stack_size > MAX_STACK:
        raise ValueError(f"traverse: the BVH needs a stack of {stack_size} entries; the kernel holds {MAX_STACK}")
    if table.shape[0] >= 1 << 30:
        raise ValueError("traverse: row ids must stay below 2^30 (the table's id encoding)")
    if table.data_ptr() % 16:
        raise ValueError("traverse: the table must be 16-byte aligned (its rows are read as float4)")
    out = TraverseOut(
        t=torch.empty(R, dtype=torch.float32, device=dev),
        tri=torch.empty(R, dtype=torch.int32, device=dev),
        inst=torch.empty(R, dtype=torch.int32, device=dev),
        u=torch.empty(R, dtype=torch.float32, device=dev),
        v=torch.empty(R, dtype=torch.float32, device=dev),
        found=torch.empty(R, dtype=torch.bool, device=dev),
        pops=torch.empty(R, dtype=torch.int32, device=dev),
    )
    if R == 0:
        return out
    from . import build

    lib = build.load()
    scratch = torch.empty(R + 2, dtype=torch.int32, device=dev)  # live-lane list, 2 counters
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    name = variant(table.shape[0], ray_mask is not None)
    rc = lib.mrt_traverse2(_ptr(table), n_internal, n_leaf, tlas_n, stack_size,
                           _ptr(origin), _ptr(direction), _ptr(tmax), _ptr(shadow), _ptr(active),
                           None if ray_mask is None else _ptr(ray_mask),
                           int(table.shape[0] > _META_MASK), R, float(t_min), _ptr(out.t),
                           _ptr(out.tri), _ptr(out.inst), _ptr(out.u), _ptr(out.v),
                           _ptr(out.found), _ptr(out.pops), _ptr(scratch), stream)
    if rc != 0:
        raise RuntimeError(f"traverse2 ({name}) kernel launch failed: CUDA error {rc}")
    launches += 1
    variant_launches[name] += 1
    return out

