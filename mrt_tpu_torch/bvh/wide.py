"""Wide (ARITY-ary) BVH with packed 128-float rows — counterpart of
``mrt_tpu/bvh/wide.py``: the constants, the host topology and the
packed-row id encoding shared with the two-level BVH, and the flat
single-level path (``two_level=False``): ``WideBVH``, its host ``build``
(native binned SAH, with SBVH reference splits on request, or Karras LBVH),
``refit`` (kernel K4 ``flat``, ``kernels/refit.py``; bit-equal to the JAX
package's table) and the
traversal entry points ``closest_hit``, ``trace_mixed`` and ``any_hit``,
which run kernel K3 (``kernels/traverse2.py:traverse_flat``). The JAX
package's TPU scheduling around its traversal loop (chunking, ray sorting,
hit priming, streaming, multipass) changes no result: its arguments are
accepted and ignored.

Row layout of the unified table (one 128-float row per entry; internal
rows first, then leaf rows):
  internal: [bminx*A|bminy*A|bminz*A|bmaxx*A|bmaxy*A|bmaxz*A|child ids*A] = 7A
  leaf:     [v0x*K|v0y*K|v0z*K|v1x*K|...|v2z*K|tri ids*K] = 10K
Integer ids ride in the f32 table as ``bitcast(id + 2^30)`` so small ids are
never denormal floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve as resolve_device
from ..core.types import Hits, Rays
from . import lbvh

ARITY = 8
LEAF_K = 12
ROW = 128
META_OFF = 6 * ARITY
IDS_OFF = 9 * LEAF_K
_EMPTY = -1  # empty child slot / leaf pad
_ID_BIAS = 1 << 30
# child sort key: [t-bits >> 20 | child id] — tables up to 2^20 rows
_META_BITS = 20
_META_MASK = (1 << _META_BITS) - 1
_KEY_MAX = (1 << 31) - 1


def _stack_size(depth: int) -> int:
    """Depth heuristic for the traversal stack when no exact bound exists."""
    return int(min(max(1 + depth * (ARITY - 1), 16), 160))


def _stack_alloc(bound, depth: int) -> int:
    """Stack width: the exact bound when the builder recorded one, at least
    ARITY (one internal row pushes up to ARITY children)."""
    return max(int(bound) if bound else _stack_size(depth), ARITY)


def encode_ids(ids: torch.Tensor) -> torch.Tensor:
    return (ids.to(torch.int32) + _ID_BIAS).view(torch.float32)


def decode_ids(floats: torch.Tensor) -> torch.Tensor:
    return floats.contiguous().view(torch.int32) - _ID_BIAS


def exact_stack_bound(kids_of, root: int = 0) -> int:
    """EXACT adversarial-order worst-case traversal stack occupancy for a
    built topology (host-side, O(nodes)).

    At a k-child node the runtime pushes all (hit) children and pops them
    one at a time; while the i-th popped child's subtree is traversed the
    stack still holds its k-1-i remaining siblings, so
    f(node) = max_i (k-1-i + f(child)) maximized over pop orders — pair
    the largest f with the earliest pop (sort f descending). Assumes every
    child can be hit, so sizing the stack to 1+f(root) can NEVER truncate;
    vs the depth*(ARITY-1) heuristic it measured 42 vs 57 on the app scene
    (a 26% cut of per-step stack shift bandwidth for free).

    ``kids_of(node) -> list[int]`` must yield traversal successors: wide
    children for internal rows, [] for leaves, the BLAS root for two-level
    instance rows."""
    f: dict = {}
    stack = [(root, False)]
    while stack:
        n, done = stack.pop()
        kids = kids_of(n)
        if not kids:
            f[n] = 0
            continue
        if not done:
            stack.append((n, True))
            for c in kids:
                if c not in f:
                    stack.append((c, False))
        else:
            fs = sorted((f[c] for c in kids), reverse=True)
            k = len(fs)
            f[n] = max((k - 1 - i) + fs[i] for i in range(k))
    return 1 + f[root]


def _binary_ranges(left: np.ndarray, right: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-leaf index range [lo, hi] covered by each binary node (leaves of
    a Karras internal node are contiguous). Combined ids: internal 0..n-2,
    leaf (n-1)+i."""
    total = 2 * n - 1
    lo = np.zeros(total, np.int64)
    hi = np.zeros(total, np.int64)
    n_int = n - 1
    lo[n_int:] = np.arange(n)
    hi[n_int:] = np.arange(n)
    # bottom-up: iterate until fixed point (depth-bounded)
    lo_i = np.full(n_int, -1, np.int64)
    hi_i = np.full(n_int, -1, np.int64)
    for _ in range(2 * n):
        l_lo = np.where(left < n_int, lo_i[np.clip(left, 0, max(n_int - 1, 0))], lo[np.clip(left, 0, total - 1)])
        r_hi = np.where(right < n_int, hi_i[np.clip(right, 0, max(n_int - 1, 0))], hi[np.clip(right, 0, total - 1)])
        new_lo = l_lo
        new_hi = r_hi
        if np.array_equal(new_lo, lo_i) and np.array_equal(new_hi, hi_i):
            break
        lo_i, hi_i = new_lo, new_hi
    lo[:n_int] = lo_i
    hi[:n_int] = hi_i
    return lo, hi


def build_topology_wide(bin_left: np.ndarray, bin_right: np.ndarray, leaf_order: np.ndarray):
    """Collapse the binary radix tree into (node_child, leaf_tri, depth).

    Entry-id space: internal rows [0, Ni), leaf rows [Ni, Ni+Nl).
    """
    n = leaf_order.shape[0]
    n_int_bin = n - 1

    if n <= LEAF_K:
        leaf = np.full((1, LEAF_K), -1, np.int32)
        leaf[0, :n] = leaf_order[:n]
        return np.zeros((0, ARITY), np.int32), leaf, 1

    lo, hi = _binary_ranges(bin_left, bin_right, n)
    count = hi - lo + 1

    node_children: list = []  # list of lists of ('I', idx) / ('L', idx)
    leaves: list = []

    def make_leaf(bin_id: int) -> int:
        tris = leaf_order[lo[bin_id] : hi[bin_id] + 1]
        row = np.full(LEAF_K, -1, np.int32)
        row[: len(tris)] = tris
        leaves.append(row)
        return len(leaves) - 1

    # Iterative DFS: emit internal nodes in preorder.
    root = 0
    node_children.append(None)  # placeholder for root
    work = [(0, root)]  # (internal row idx, binary node id)
    while work:
        row_idx, bin_id = work.pop()
        # Expand to up to ARITY subtree roots, splitting the largest first.
        roots = [bin_id]
        while len(roots) < ARITY:
            best, best_count = -1, LEAF_K
            for k, r in enumerate(roots):
                c = int(count[r]) if r < n_int_bin else 1
                if r < n_int_bin and c > best_count:
                    best, best_count = k, c
            if best < 0:
                break
            r = roots.pop(best)
            roots.insert(best, int(bin_right[r]))
            roots.insert(best, int(bin_left[r]))
        children = []
        for r in roots:
            c = int(count[r]) if r < n_int_bin else 1
            if r >= n_int_bin or c <= LEAF_K:
                # binary leaf or small subtree -> wide leaf row
                if r >= n_int_bin:
                    # single binary leaf
                    tri = leaf_order[r - n_int_bin]
                    row = np.full(LEAF_K, -1, np.int32)
                    row[0] = tri
                    leaves.append(row)
                    children.append(("L", len(leaves) - 1))
                else:
                    children.append(("L", make_leaf(r)))
            else:
                node_children.append(None)
                idx = len(node_children) - 1
                children.append(("I", idx))
                work.append((idx, r))
        node_children[row_idx] = children

    n_i = len(node_children)
    child_arr = np.full((n_i, ARITY), _EMPTY, np.int32)
    for i, children in enumerate(node_children):
        for j, (kind, idx) in enumerate(children):
            child_arr[i, j] = idx if kind == "I" else n_i + idx
    leaf_arr = np.stack(leaves).astype(np.int32)

    # depth for refit trip count
    depth = np.ones(n_i, np.int32)
    for i in range(n_i - 1, -1, -1):
        for j in range(ARITY):
            c = child_arr[i, j]
            if 0 <= c < n_i:
                depth[i] = max(depth[i], depth[c] + 1)
    return child_arr, leaf_arr, int(depth[0]) + 1


# ---------------------------------------------------------------------------
# The flat single-level BVH: table, host build, refit (kernel K4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WideBVH:
    """Unified flat table over world-space triangles (tensors on one device)."""

    table: torch.Tensor  # (N, ROW) f32: internal rows [0, n_internal), then leaf rows
    node_child: torch.Tensor  # (Ni, ARITY) int32 entry ids, -1 = empty
    leaf_tri: torch.Tensor  # (Nl, LEAF_K) int32 global triangle ids, -1 = pad
    n_internal: int
    depth: int
    # the exact worst-case stack occupancy (exact_stack_bound); None falls
    # back to the depth heuristic
    stack_bound: int | None = None
    # SBVH: (Nl, 6) f32 per-leaf clip boxes [min xyz, max xyz] from the
    # spatial-split builder, which refit intersects with the leaf boxes;
    # valid only for the vertices the builder saw
    leaf_clip: torch.Tensor | None = None
    # what the refit kernel's walk-up reads (``kernels/refit.py:Walkup``),
    # derived from node_child where the BVH is made; a refit on the card
    # needs it
    walkup: object | None = None

    has_masks = False  # no per-instance geometry masks on the flat path

    @property
    def n_rows(self) -> int:
        return self.table.shape[0]

    @property
    def stack_size(self) -> int:
        """Traversal stack entries a lane needs."""
        return _stack_alloc(self.stack_bound, self.depth)

    def _replace(self, **kw) -> "WideBVH":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "WideBVH":
        """The same BVH with every tensor on ``device``."""
        return self._replace(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)
                                if hasattr(getattr(self, f.name), "to")})


def refit(wbvh: WideBVH, v0, v1, v2, row_ids=None) -> WideBVH:
    """The table rebuilt from (T,3) world-space triangle vertices: leaf rows
    (vertices and ids) and every internal row's child boxes, bottom-up
    (kernel K4 ``flat``, ``kernels/refit.py``; its plain version on the
    CPU). ``row_ids``: optional (Nl, LEAF_K) ids to encode in the leaf rows
    in place of ``leaf_tri`` (a shard's rows read vertices by local ids but
    report global ones). Returns a new BVH."""
    from ..kernels import refit as refit_k

    return wbvh._replace(table=refit_k.flat(wbvh, v0, v1, v2, row_ids))


def topology(v0, v1, v2, method: str = "auto", spatial: bool = False):
    """The host half of ``build``: (node_child, leaf_tri, depth, leaf clip
    boxes or None) as NumPy over (T,3) triangle vertices."""
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    if method in ("auto", "sah"):
        from ..utils import native

        return native.build_wide_bvh_sah(np.concatenate([v0, v1, v2], axis=1), ARITY, LEAF_K,
                                         spatial=spatial)
    if method == "lbvh":
        bl, br, _, order, _ = lbvh.build_topology((v0 + v1 + v2) / 3.0)
        return build_topology_wide(bl, br, order) + (None,)
    raise ValueError(f"unknown BVH build method {method!r}")


def build(v0, v1, v2, method: str = "auto", spatial: bool = False, device=None) -> WideBVH:
    """Host topology build over (T,3) world-space triangle vertices (NumPy),
    then a refit on ``device`` (default: the card).

    ``method``: "sah" or "auto" (the native binned-SAH builder; a failed
    native build raises) or "lbvh" (the Karras tree, collapsed).
    ``spatial=True`` asks the native builder for SBVH reference splits: the
    BVH then carries leaf clip boxes that ``refit`` honours, so it suits
    only geometry that is never refit with other vertices."""
    from ..kernels import refit as refit_k

    device = resolve_device(device)
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    child, leaf, depth, clip = topology(v0, v1, v2, method, spatial)
    n_i = int(child.shape[0])
    bound = exact_stack_bound(
        lambda n: [int(c) for c in child[n] if c >= 0] if n < n_i else []) if n_i else 1
    wbvh = WideBVH(
        table=torch.zeros((n_i + leaf.shape[0], ROW), dtype=torch.float32, device=device),
        node_child=torch.as_tensor(child).to(device), leaf_tri=torch.as_tensor(leaf).to(device),
        n_internal=n_i, depth=int(depth), stack_bound=bound,
        leaf_clip=None if clip is None else torch.as_tensor(clip).to(device),
        walkup=refit_k.flat_walkup(child, leaf.shape[0], device))
    return refit(wbvh, *(torch.as_tensor(v).to(device) for v in (v0, v1, v2)))


# ---------------------------------------------------------------------------
# Traversal (kernel K3)
# ---------------------------------------------------------------------------

# the JAX package's TPU scheduling arguments: accepted, and ignored (none
# changes a result; priming re-tests its candidate)
_SCHEDULING = frozenset(("chunks", "sort_rays", "prime_tri", "tri_rows", "stream_window",
                         "refill_every", "unroll", "sort_hint"))


def _traverse(wbvh: WideBVH, rays: Rays, shadow, mask, t_min: float, scheduling: dict):
    from ..kernels import traverse2

    unknown = set(scheduling) - _SCHEDULING
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    n = rays.origin.shape[0]
    dev = rays.origin.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    return traverse2.traverse_flat(
        wbvh.table, wbvh.n_internal, wbvh.stack_size, rays.origin.contiguous(),
        rays.direction.contiguous(), rays.max_distance.contiguous(), shadow.contiguous(),
        mask.contiguous(), t_min)


def _hits(out) -> Hits:
    from ..kernels.traverse2 import hits_of

    return hits_of(out)


def closest_hit(wbvh: WideBVH, rays: Rays, t_min: float = 0.0, mask=None,
                count_pops: bool = False, **scheduling):
    """Closest hit per ray (triangle ids are the scene's global ids; t is
    inf and the triangle -1 on a miss); with ``count_pops`` also the rows
    each lane popped."""
    shadow = torch.zeros(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    out = _traverse(wbvh, rays, shadow, mask, t_min, scheduling)
    return (_hits(out), out.pops) if count_pops else _hits(out)


def closest_raw(wbvh: WideBVH, rays: Rays, flags, mask=None):
    """The closest-hit traversal's own record (``kernels.traverse2.TraverseOut``:
    global triangle ids, instance -1; t is the ray's max distance on a
    miss), for a caller that reads it itself, as the wavefront's K7 does
    (``traverse2.hits_of`` gives ``closest_hit``'s record from it).
    ``flags``: an all-False (R,) bool, the traversal's shadow flags, made
    once by a caller that traces many batches."""
    return _traverse(wbvh, rays, flags, mask, 0.0, {})


def trace_mixed(wbvh: WideBVH, rays: Rays, shadow, t_min: float = 0.0, mask=None,
                count_pops: bool = False, **scheduling):
    """One traversal over a mixed batch: ``shadow`` lanes retire at their
    first hit, the others find the closest. Returns (Hits, occluded) and,
    with ``count_pops``, the pops."""
    out = _traverse(wbvh, rays, shadow, mask, t_min, scheduling)
    res = (_hits(out), out.found & shadow)
    return res + (out.pops,) if count_pops else res


def any_hit(wbvh: WideBVH, rays: Rays, t_min: float = 0.0, mask=None,
            return_tri: bool = False, count_pops: bool = False, flags=None, **scheduling):
    """Occlusion per ray within ``rays.max_distance``; with ``return_tri``
    also the first blocking triangle found (-1 if none), with ``count_pops``
    the pops. ``flags``: an all-True (R,) bool to use as the traversal's
    shadow flags (made once by a caller that traces many batches; made here
    if None)."""
    if flags is None:
        flags = torch.ones(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    out = _traverse(wbvh, rays, flags, mask, t_min, scheduling)
    res = (out.found,)
    if return_tri:
        res += (torch.where(out.found, out.tri, -1),)
    if count_pops:
        res += (out.pops,)
    return res if len(res) > 1 else res[0]
