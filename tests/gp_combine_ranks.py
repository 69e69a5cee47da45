"""Rank-side cases of ``test_torch_gp_combine.py``, run in its gloo world
through ``dist.launch.on_mesh``: a gp step's hit combine and occlusion over
the live lanes (``kernels/wavefront.gp_combine``, ``lane_occluded``) beside
the full-width reference (``render/wavefront.combine_hits_across``,
``_tri_rows``, ``comm.pmax``) on the same per-rank inputs. This module
imports no JAX: the world's ranks import it."""

import torch

from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.dist import comm
from mrt_tpu_torch.kernels import traverse2
from mrt_tpu_torch.kernels import wavefront as W
from mrt_tpu_torch.render import wavefront as wf


def combine_case(t, tri, u, v, live, shade_rows, motion_rows, g2l, occluded, need, axis) -> dict:
    """This rank's hits ((P,) each), the step's live lanes, its shard's
    rows and ``g2l``, and its shadow rays' occlusion and need: the
    full-width reference (``ref_*``: the combined hit, the shade and motion
    rows of its triangle, the occlusion's max) and the live-lane combine
    (``live_*``: the record K16 wrote, the rows and payload after their
    psum, the map, the occlusion K16's second form wrote)."""
    geom = wf.Geometry(None, None, None, None, None, None, shade_rows, motion_rows, None, g2l=g2l,
                       axis=axis)
    ref = wf.combine_hits_across(T.Hits(t, tri, u, v), axis)
    ids = ref.triangle.clamp_min(0).long()
    ref_shade = W._tri_rows(shade_rows, ids, geom)
    ref_motion = W._tri_rows(motion_rows, ids, geom)
    ref_occ = comm.pmax(occluded.to(torch.int32), axis) > 0
    P = t.shape[0]
    none = torch.full((P,), -1, dtype=torch.int32)
    hits = traverse2.TraverseOut(t.clone(), tri.clone(), none, u.clone(), v.clone(), tri >= 0,
                                 torch.zeros(P, dtype=torch.int32))
    n_live = int(live.sum())
    flat, pos, lane_of = W.gp_combine(geom, hits, live, n_live, motion=True)
    occ = W.lane_occluded(occluded.clone(), lane_of, axis)
    shade, motion = W.split_rows(flat[:n_live * 34], n_live, True, True)
    return dict(ref_t=ref.t, ref_tri=ref.triangle, ref_u=ref.u, ref_v=ref.v, ref_shade=ref_shade,
                ref_motion=ref_motion, ref_occ=ref_occ, live_t=hits.t, live_tri=hits.tri,
                live_u=hits.u, live_v=hits.v, live_shade=shade, live_motion=motion,
                payload=flat[n_live * 34:].view(torch.int32).view(n_live, W.PAYLOAD_COLS),
                pos=pos, lane_of=lane_of, live_occ=occ, need=need)


def in_place(fn, x, axis):
    """``fn`` (``comm.pmin_`` or ``pmax_``) on ``x``: (whether it returned
    ``x`` itself, ``x`` after it)."""
    y = fn(x, axis)
    return y is x, x
