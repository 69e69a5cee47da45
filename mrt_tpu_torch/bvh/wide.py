"""Wide-BVH constants, host topology and the packed-row id encoding —
counterpart of the host half of ``mrt_tpu/bvh/wide.py``.

Row layout of the unified table (one 128-float row per entry):
  internal: [bminx*A|bminy*A|bminz*A|bmaxx*A|bmaxy*A|bmaxz*A|child ids*A] = 7A
  leaf:     [v0x*K|v0y*K|v0z*K|v1x*K|...|v2z*K|tri ids*K] = 10K
Integer ids ride in the f32 table as ``bitcast(id + 2^30)`` so small ids are
never denormal floats.
"""

from __future__ import annotations

import numpy as np
import torch

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
