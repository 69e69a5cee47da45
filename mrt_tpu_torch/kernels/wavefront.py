"""Kernels K6 — sample_start —, K7 — shade_hit — and K8 — resolve_shadow —
(``csrc/wavefront.cu``, Halton in ``csrc/halton.cuh``), their wrappers, their
plain PyTorch versions and the per-lane state they pass along.

They replace the body of ``mrt_tpu/render/wavefront.py:trace_tile``, which
XLA fuses into a few programs per bounce on the TPU: K6 the camera rays and
the per-sample state (``camera_rays``/``init_state``, :290-363), K7 and K8
the bounce loop's body (:372-1020) around the two traversals. Per sample,
``render/wavefront.py:trace_pixels`` runs ``sample_start``, then per
iteration the closest-hit traversal, ``shade_hit`` and the any-hit
traversal of the shadow rays, and after the last iteration
``resolve_shadow``:

- ``sample_start``: Halton dims 0/1 (24 digits) of each pixel's index, the
  camera ray, and a fresh ``LaneState`` (a lane past its own sample count
  starts dead);
- ``shade_hit``: first the previous iteration's shadow rays
  (``accumulated += contrib`` where one was cast and is not occluded: the
  add K8 made after every any-hit in the full-width design), then
  everything between the two traversals — the hit record, the environment on a miss, the normal,
  the material, the glass branch with its Halton transparency dimension,
  emission, the five post-glass Halton dimensions, the 1-of-N light pick
  (uniform or ``power``) and the four light types, PBR or legacy shading,
  the shadow ray — and the throughput, dead-lane and cosine-bounce update
  that follows the shadow ray, which reads neither the occlusion nor the
  radiance sum, so it runs before the any-hit traversal. It writes the next
  ray into the state and the shadow ray, its radiance and its lane mask into
  the ``Wave``'s ``Shadow``, and the lanes the next step runs over (those
  live or holding a shadow ray) into its list;
- ``resolve_shadow``: the last iteration's shadow rays, once per sample.
The radiance is summed in the plain loop's order: env(k), emission(k),
contrib(k), env(k+1).

On the card, K7 replaces a one-thread-per-lane K7 and a full-width K8
per iteration: it is persistent over a device-side lane list that each
launch writes for the next (the first launch of a sample runs over every
lane), reads the closest-hit traversal's raw record
(``traverse2.TraverseOut``) and makes the flat triangle id itself, and
reads its shade and material rows as float4. Its buffers (the two lists,
the counters, the ``Shadow``) are made once per ``trace_pixels`` call
(``make_wave``) and its counters zeroed once per sample (``new_sample``);
the host reads one int32 per launch, the live-lane count, to end the loop.
Its bound counts the listed lanes and the adds it folds in
(``utils/bounds.py:k7_listed``, ``k8``).

The plain version of the new K7 is ``resolve_shadow_plain`` followed by
``shade_hit_plain``, both the port's torch-op body as it was, over every
lane, with the list as the lanes ``active | need``
(``shade_hit_listed_plain``); of the trailing K8 ``resolve_shadow_plain``
(``resolve_shadow_listed_plain``). Every frame takes the kernel route;
``trace_pixels(..., plain=True)`` runs the plain route instead, the plain
stages on ``closest_hit``'s records, for the checks. On the route, the wrappers take
the plain versions only for CPU tensors; on CUDA tensors they launch the
kernels or raise.

Under geometry sharding (the gp axis, ``dist/geometry.py``) a rank holds
only its shard's shade and motion rows, and maybe one row band of the
packed atlas. A collective cannot run inside K7, so each step is split at
its collectives, all over its live lanes only, compacted in lane order
(``lane_rows``, ``gp_combine``): K13's scan (``gp_scan``) maps each live
lane to its position (``pos``, -1 where dead) and back (``lane_of``);
K15 ``gp_hit_keys`` writes each row's int64 key, ``(bits(t) << 32) |
rank`` (``NO_WINNER`` without a hit), and one in-place min over gp of the
keys gives the JAX package's ``combine_hits_across`` min-t and winning
rank at once; K13's gather (``gp_gather``) has the winner write the
payload (triangle + 1, u, v) and its shard's rows of the triangle, the
others zeros, and one int32 psum completes hit and rows (each element has
one nonzero contributor: exact); K16 ``gp_lane_unpack`` writes the
combined hit into the closest-hit record where K7 reads it. On a banded
atlas with maps K14 ``banded_taps`` writes this rank's share of each live
lane's packed sample at the same position, and a second psum completes
it; then K7's lane-row form (``k7_variant`` bit 3, with bit 4 the
per-lane taps) reads them at ``pos[i]``. The step's shadow rays come from
its live lanes, so their occlusion takes the same map (``lane_occluded``:
K15's and K16's second forms around an in-place max of uint8). The flags
are the same on every rank (gp replicates the rays), so the map is too,
and every rank issues collectives of the same sizes. Their plain versions
are ``torch.cumsum``/``torch.nonzero``'s map (``gp_scan_plain``), the
keys, gather and unpack in torch ops (``gp_hit_keys_plain``,
``gp_gather_plain``, ``gp_lane_unpack_plain`` and the occlusion's
``gp_occluded_rows_plain``, ``gp_occluded_lanes_plain``) and
``assets/texture.sample_packed_banded`` (``banded_taps_plain``); sample
0's motion rows go through K13's own rows (``gp_rows``, the local half of
``_tri_rows``; ``gp_rows_plain``). The plain route keeps the full-width
``render/wavefront.combine_hits_across`` and ``_tri_rows`` and
``sample_packed_across`` inside K7's plain body.

K7 has one instantiation per ``k7_variant`` (``K7_VARIANTS``): the
untextured one, and with the scene's texture maps (the packed atlas's
four taps, of the float4 groups that the hit's maps read, ``map_groups``,
``hit_groups``; or with ``use_mipmaps`` the ray cone's length and LOD and
two taps of each map's mip chain, a texel one 16-B load of the atlas's
``texels4``; a normal map bends the shading normal), and
in a debug view (the colour at the first hit, the lane retired, no shadow
ray), alone or with the maps; under geometry sharding each of these in
the lane-row form (bit 3), on a banded atlas with the per-lane taps (bit
4).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from ..assets import texture as tex
from ..core import halton as H
from ..core import types as T
from ..dist import comm
from ..render import shade as S
from . import traverse2
from .traverse2 import _check

STAGES = ("sample_start", "shade_hit", "resolve_shadow")
# K13, K14, K15 and K16: geometry sharding's (each of K15's and K16's two
# forms counts as its kernel's launch)
GP_STAGES = ("gp_rows", "banded_taps", "gp_hit_keys", "gp_lane_unpack")
GP_TILE = 1024  # K13's lanes a block (csrc/wavefront.cu:GP_TILE)
# a gp step's hit keys: the low word where a rank has no hit
# (csrc/wavefront.cu:NO_WINNER); the payload's int32 columns a row (the
# triangle + 1, the bits of u and v)
NO_WINNER = 1 << 30
PAYLOAD_COLS = 3
launches = dict.fromkeys(STAGES + GP_STAGES, 0)  # kernel launches in this process, by stage
# K7's instantiations (csrc/wavefront.cu:TEX_KERNELS) by k7_variant, and
# their launches in this process
K7_VARIANTS = {0: "untextured", 1: "maps", 3: "maps_mips", 4: "debug", 5: "maps_debug",
               7: "maps_mips_debug", 8: "rows", 9: "rows_maps", 11: "rows_maps_mips",
               12: "rows_debug", 13: "rows_maps_debug", 15: "rows_maps_mips_debug",
               25: "rows_maps_taps", 29: "rows_maps_taps_debug"}
variant_launches = dict.fromkeys(K7_VARIANTS.values(), 0)

# K7's per-light table: [type pos(3) color(3) direction(3) forward(3) right(3)
# up(3) cos(cone_angle) pmf cdf], one row per light
LIGHT_COLS = 22


def reset_launches():
    """Set every stage's and K7 instantiation's launch count to 0."""
    for k in launches:
        launches[k] = 0
    for k in variant_launches:
        variant_launches[k] = 0


class LaneState(NamedTuple):
    """Every per-lane tensor of one sample's bounce loop; (P,) unless noted.
    The G-buffer fields (sample 0's first hit) are None unless
    ``settings.enable_gbuffer``; they carry over from sample to sample."""

    ray_o: torch.Tensor  # (P,3) f32
    ray_d: torch.Tensor  # (P,3) f32
    color: torch.Tensor  # (P,3) f32 path throughput
    accumulated: torch.Tensor  # (P,3) f32 this sample's radiance
    bounce: torch.Tensor  # int32
    step: torch.Tensor  # int32 Halton step (bounces and transparency passes)
    tpasses: torch.Tensor  # int32 transparency passes since the last bounce
    active: torch.Tensor  # bool
    rays: torch.Tensor  # int32 traversals launched for this lane
    prim_tri: torch.Tensor  # int32 sample 0's bounce-0 hit (-1: none)
    prim_u: torch.Tensor  # f32
    prim_v: torch.Tensor  # f32
    cone_t: torch.Tensor  # f32 path length, for the mip LOD
    diffuse_albedo: torch.Tensor | None = None  # (P,3)
    specular_albedo: torch.Tensor | None = None  # (P,3)
    normal: torch.Tensor | None = None  # (P,3)
    roughness: torch.Tensor | None = None  # (P,)
    wrote_gb: torch.Tensor | None = None  # bool


class LaneRows(NamedTuple):
    """One gp step's rows of its n live lanes (``lane_rows``), compacted in
    lane order and each complete on every rank after its psum: row
    ``pos[i]`` holds live lane i's hit triangle's shade row, its motion row
    where the frame needs one (``needs_motion_rows``) and, on a banded
    atlas with maps, its packed sample (``needs_lane_taps``); rows of live
    lanes without a hit are zeros, dead lanes have none (``at_lanes``
    reads them per lane)."""

    shade: torch.Tensor  # (n,16) f32
    motion: torch.Tensor | None = None  # (n,18) f32
    taps: torch.Tensor | None = None  # (n,16) f32
    pos: torch.Tensor | None = None  # (P,) int32: each lane's row, -1 where dead
    lane_of: torch.Tensor | None = None  # (n,) int32: each row's lane


def at_lanes(rows: LaneRows) -> LaneRows:
    """``rows`` read at each lane's position: (P, cols) rows, zeros for a
    lane without one (dead)."""
    has = (rows.pos >= 0)[:, None]
    idx = rows.pos.clamp_min(0).long()

    def at(t):
        if t is None:
            return None
        if t.shape[0] == 0:
            return t.new_zeros((idx.shape[0], t.shape[1]))
        return torch.where(has, t[idx], 0.0)

    return LaneRows(at(rows.shade), at(rows.motion), at(rows.taps), rows.pos)


class LaneBuffers(NamedTuple):
    """A ``trace_pixels`` call's buffers of the gp steps' rows on the card
    (``make_wave``), made once for P lanes: each step uses their first
    n_live rows, so the kernels' pointers stay fixed."""

    # (P * (16 + 18 * motion + PAYLOAD_COLS),) f32: K13's gather writes n shade
    # rows, then n motion rows, then the n rows' payload (int32 bits)
    flat: torch.Tensor
    motion: bool  # whether the frame needs the motion rows
    taps: torch.Tensor | None  # (P,16) f32: K14's (banded atlas with maps), else None
    pos: torch.Tensor  # (P,) int32
    lane_of: torch.Tensor  # (P,) int32
    counts: torch.Tensor  # (tiles,) int32: K13's live lanes per tile of GP_TILE lanes
    keys: torch.Tensor  # (P,) int64: K15's hit keys
    occ: torch.Tensor  # (P,) uint8: K15's occlusion rows


GBUFFER_FIELDS = ("diffuse_albedo", "specular_albedo", "normal", "roughness", "wrote_gb")

# each LaneState field's dtype and columns (0: a (P,) vector)
_STATE_LAYOUT = dict(
    ray_o=(torch.float32, 3), ray_d=(torch.float32, 3), color=(torch.float32, 3),
    accumulated=(torch.float32, 3), bounce=(torch.int32, 0), step=(torch.int32, 0),
    tpasses=(torch.int32, 0), active=(torch.bool, 0), rays=(torch.int32, 0),
    prim_tri=(torch.int32, 0), prim_u=(torch.float32, 0), prim_v=(torch.float32, 0),
    cone_t=(torch.float32, 0), diffuse_albedo=(torch.float32, 3),
    specular_albedo=(torch.float32, 3), normal=(torch.float32, 3), roughness=(torch.float32, 0),
    wrote_gb=(torch.bool, 0))


class Shadow(NamedTuple):
    """``shade_hit``'s shadow rays: origin, direction and extent are the
    any-hit batch, ``contrib`` the radiance each adds if unoccluded; all are
    defined only where ``need`` is set."""

    origin: torch.Tensor  # (P,3) f32
    direction: torch.Tensor  # (P,3) f32
    distance: torch.Tensor  # (P,) f32
    contrib: torch.Tensor  # (P,3) f32
    need: torch.Tensor  # (P,) bool


class Frame(NamedTuple):
    """What the stages read that stays fixed over one ``trace_pixels`` call
    (``had0``/``motion0``: sample 0's hit record, set after sample 0, for
    the motion view; ``camera``/``lights``: the kernels' packed tables, made
    by ``make_frame`` on the kernel route on a CUDA device, else None;
    ``prev_camera`` the same for the motion view)."""

    settings: T.RenderSettings
    statics: object  # engine.scene.SceneStatics
    scene: object  # engine.scene.SceneData
    geom: object  # render.wavefront.Geometry
    uniforms: T.FrameUniforms
    pixel_x: torch.Tensor  # (P,) int32
    pixel_y: torch.Tensor  # (P,) int32
    offsets: torch.Tensor  # (P,) int32 Halton index offsets
    prev_motion: torch.Tensor  # (P,2) f32
    base: int  # Halton index base of sample 0
    width_f: torch.Tensor  # 0-d f32
    height_f: torch.Tensor  # 0-d f32
    pixel_angle: torch.Tensor | None = None  # 0-d f32 (mipmaps)
    had0: torch.Tensor | None = None
    motion0: torch.Tensor | None = None
    camera: torch.Tensor | None = None  # (12,) f32: position right up forward
    lights: torch.Tensor | None = None  # (L, LIGHT_COLS) f32
    step_bases: torch.Tensor | None = None  # (20, 12) int32: halton._STEP_BASES_PAIR
    # a two-level BVH's first flat triangle id per instance (I,) int32, which
    # turns the closest-hit traversal's local ids into flat ones; None for a
    # flat table
    tri_base: torch.Tensor | None = None
    prev_camera: torch.Tensor | None = None  # (12,) f32: the previous frame's camera


def k7_variant(settings: T.RenderSettings, statics, banded: bool = False) -> int:
    """The key in ``K7_VARIANTS`` of the K7 instantiation a frame takes:
    bit 0 the scene has a texture map or mipmapped sampling is on (which
    carries the ray cone's length: the maps' instantiation, sampling no
    map where the scene has none), bit 1 mipmapped sampling, bit 2 a debug
    view, bit 3 geometry sharding (the lane-row form), bit 4 its per-lane
    taps (``banded``: the atlas is banded over gp; ``needs_lane_taps``)."""
    mips = bool(settings.use_mipmaps)
    v = ((bool(any(statics.any_map)) or mips) | (mips << 1)
         | ((settings.debug_mode != T.DEBUG_MODE_NONE) << 2))
    if settings.geometry_axis:
        v |= 8 | (needs_lane_taps(settings, statics, banded) << 4)
    return v


def needs_motion_rows(settings: T.RenderSettings, statics) -> bool:
    """Whether K7 reads the hits' motion rows: for the mip LOD, the motion
    view, or the tangent basis of a normal map."""
    return bool(settings.use_mipmaps or settings.debug_mode == T.DEBUG_MODE_MOTION
                or statics.any_map[tex.MAP_NORMAL])


def needs_lane_taps(settings: T.RenderSettings, statics, banded: bool) -> bool:
    """Whether a gp step samples the packed atlas through K14 (a banded
    atlas, a scene with maps, no mipmaps: those sample the whole mip
    chains, which every rank holds)."""
    return bool(banded and any(statics.any_map) and not settings.use_mipmaps)


def pack_lights(lights: T.Lights, light_sampling: str) -> torch.Tensor:
    """(L, LIGHT_COLS) f32: K7's light table, with the cone's cosine and the
    ``power`` pmf and cdf computed by the plain version's torch ops (so the
    values are the plain version's own); pmf and cdf are 0 unless ``power``
    sampling picks among several lights."""
    n = lights.type.shape[0]
    pmf = cdf = torch.zeros(n, dtype=torch.float32, device=lights.type.device)
    if light_sampling == "power" and n > 1:
        pmf, cdf = _power_pmf_cdf(lights)
    return torch.cat([lights.type.to(torch.float32)[:, None], lights.position, lights.color,
                      lights.direction, lights.forward, lights.right, lights.up,
                      torch.cos(lights.cone_angle)[:, None], pmf[:, None], cdf[:, None]],
                     dim=1).contiguous()


def _pack_camera(cam: T.Camera) -> torch.Tensor:
    """(12,) f32: position right up forward."""
    return torch.cat([cam.position, cam.right, cam.up, cam.forward]).to(torch.float32).contiguous()


def make_frame(settings, statics, scene, geom, uniforms, pixel_x, pixel_y, offsets, prev_motion,
               base: int, tri_base: torch.Tensor | None = None, plain: bool = False) -> Frame:
    """The ``Frame`` of one ``trace_pixels`` call, with the kernels' packed
    tables where its stages run as kernels (on CUDA, unless ``plain``: the
    plain route); ``tri_base``: the two-level BVH's ``flat_tri_base`` (None
    for a flat table)."""
    dev = pixel_x.device
    f32 = torch.float32
    # 0-d device tensors: a Python scalar numerator would turn ``c / x`` into
    # ``reciprocal(x) * c`` (two roundings), and a CUDA ``x / c`` into ``x * (1/c)``
    width_f = torch.tensor(float(settings.width), dtype=f32, device=dev)
    height_f = torch.tensor(float(settings.height), dtype=f32, device=dev)
    cam = uniforms.camera
    pixel_angle = None
    if settings.use_mipmaps:
        # the pixel's angular size, for the ray cone's footprint
        up_len = torch.sqrt((cam.up ** 2).sum())
        fwd_len = torch.sqrt((cam.forward ** 2).sum())
        pixel_angle = 2.0 * up_len / (height_f * torch.clamp(fwd_len, min=1e-5))
    packed = {}
    if dev.type == "cuda" and not plain:
        packed = dict(
            camera=_pack_camera(cam), lights=pack_lights(scene.lights, settings.light_sampling),
            step_bases=torch.as_tensor(H._STEP_BASES_PAIR).to(dev).contiguous())
        if settings.debug_mode == T.DEBUG_MODE_MOTION:
            packed["prev_camera"] = _pack_camera(uniforms.previous_camera)
    return Frame(settings, statics, scene, geom, uniforms, pixel_x, pixel_y, offsets, prev_motion,
                 base, width_f, height_f, pixel_angle, tri_base=tri_base, **packed)


@dataclasses.dataclass
class WaveBuffers:
    """K7's and K8's buffers for one ``trace_pixels`` call on the card
    (``make_wave``), with what the wrappers checked and packed once: the
    frame and the state last seen (by identity) and their pointers."""

    shadow: Shadow  # the shadow rays, written in place by every K7 launch
    lists: torch.Tensor  # (2, P) int32: step s reads list s % 2, writes (s + 1) % 2;
    #                      the live lanes from the front, the others from the back
    counters: torch.Tensor  # (2 * (max_steps + 1),) int32: per step slot its list's
    #                         live lanes and other lanes; zeroed per sample
    frame: Frame
    frame_ptrs: object
    maps_ptrs: object  # the textured and debug instantiations' (_maps_ptrs)
    shadow_ptrs: object
    state: LaneState | None = None
    state_ptrs: object = None
    # geometry sharding: the buffers of K13's and K14's compacted rows
    # (None off gp)
    lane: LaneBuffers | None = None

    @property
    def max_steps(self) -> int:
        return self.counters.shape[0] // 2 - 1


class Wave(NamedTuple):
    """What a sample's steps hand on, beside the lane state: the shadow rays
    the last ``shade_hit`` cast (``need`` set on every lane), their
    occlusion once the any-hit traversal has traced them, and the lanes the
    next step runs over. On the kernel route on the card (``buf``) the
    shadow rays and the list live in buffers made once per call and written
    in place; elsewhere each step returns new tensors."""

    shadow: Shadow | None = None  # None: no shadow ray pending
    occluded: torch.Tensor | None = None  # (P,) bool, set by the caller after the any-hit
    keep: torch.Tensor | None = None  # plain: (P,) bool, the next step's lanes (None: every lane)
    steps: int = 0  # ``shade_hit`` steps run in this sample
    buf: WaveBuffers | None = None


def make_wave(fr: Frame, max_steps: int) -> Wave:
    """A ``trace_pixels`` call's ``Wave``: on the kernel route on the card
    (``fr`` made by ``make_frame`` with the packed tables) with K7's and
    K8's buffers for at most ``max_steps`` steps a sample (the frame is
    checked here, once); elsewhere without."""
    if fr.camera is None:
        return Wave()
    what = "make_wave"
    dev = _cuda_route(what, fr)
    P = fr.pixel_x.shape[0]
    _check_frame(what, fr, P, dev, rows=True)
    f32 = torch.float32
    sh = Shadow(torch.empty((P, 3), dtype=f32, device=dev),
                torch.empty((P, 3), dtype=f32, device=dev),
                torch.empty(P, dtype=f32, device=dev), torch.empty((P, 3), dtype=f32, device=dev),
                torch.zeros(P, dtype=torch.bool, device=dev))
    lane = None
    if fr.settings.geometry_axis:
        motion = needs_motion_rows(fr.settings, fr.statics)
        taps = None
        if needs_lane_taps(fr.settings, fr.statics, fr.scene.atlas.band_lo is not None):
            taps = torch.zeros((P, tex.PACKED_C), dtype=f32, device=dev)
        i32 = torch.int32
        lane = LaneBuffers(torch.zeros(P * (16 + 18 * motion + PAYLOAD_COLS), dtype=f32,
                                       device=dev), motion, taps,
                           torch.empty(P, dtype=i32, device=dev),
                           torch.empty(P, dtype=i32, device=dev),
                           torch.empty(-(-P // GP_TILE), dtype=i32, device=dev),
                           torch.empty(P, dtype=torch.int64, device=dev),
                           torch.empty(P, dtype=torch.uint8, device=dev))
    buf = WaveBuffers(sh, torch.empty((2, P), dtype=torch.int32, device=dev),
                      torch.zeros(2 * (max_steps + 1), dtype=torch.int32, device=dev), fr,
                      _frame_ptrs(fr, lane), _maps_ptrs(fr, lane), _ptrs(list(sh)), lane=lane)
    return Wave(buf=buf)


def new_sample(wv: Wave) -> Wave:
    """``wv`` at a sample's start: nothing pending, every lane to run; on
    the card the counters zeroed (once per sample)."""
    if wv.buf is not None:
        wv.buf.counters.zero_()
    return Wave(buf=wv.buf)


def listed(wv: Wave) -> torch.Tensor:
    """The lanes the next ``shade_hit`` step of ``wv`` runs over (int32, in
    no set order; every lane before a sample's first step)."""
    b = wv.buf
    if b is not None:
        P = b.lists.shape[1]
        if wv.steps == 0:
            return torch.arange(P, dtype=torch.int32, device=b.lists.device)
        n_live, n_rest = b.counters[2 * wv.steps:2 * wv.steps + 2].tolist()
        lst = b.lists[wv.steps % 2]
        return torch.cat([lst[:n_live], lst[P - n_rest:]])
    if wv.keep is None:
        raise ValueError("listed: a plain Wave before its first step lists every lane; it does "
                         "not know how many")
    return torch.nonzero(wv.keep).squeeze(1).to(torch.int32)


def clone_wave(wv: Wave) -> Wave:
    """A copy of ``wv`` with buffers of its own, for running a step twice
    on the same input (K7 writes its buffers in place)."""
    b = wv.buf

    def c(t):
        return None if t is None else t.clone()

    if b is None:
        sh = None if wv.shadow is None else Shadow(*(c(t) for t in wv.shadow))
        return Wave(sh, c(wv.occluded), c(wv.keep), wv.steps)
    sh = Shadow(*(t.clone() for t in b.shadow))
    # the rows are K7's inputs, not written by it: shared
    nb = WaveBuffers(sh, b.lists.clone(), b.counters.clone(), b.frame, b.frame_ptrs, b.maps_ptrs,
                     _ptrs(list(sh)), lane=b.lane)
    return Wave(None if wv.shadow is None else sh, c(wv.occluded), None, wv.steps, nb)


# ---------------------------------------------------------------------------
# Helpers of the plain body
# ---------------------------------------------------------------------------

def _where3(m, a, b):
    return torch.where(m[:, None], a, b)


def _tri_rows(table: torch.Tensor, tri: torch.Tensor, geom) -> torch.Tensor:
    """Per-hit rows of ``table`` for the (P,) triangle ids ``tri``. Under
    geometry sharding the rank that owns a triangle gathers its row, the
    others add zeros, and a psum over the gp axis gives every rank the row
    (exact; -0.0 comes back as +0.0)."""
    if geom.g2l is None:
        return table[tri]
    loc = geom.g2l[tri].long()
    rows = torch.where((loc >= 0)[:, None], table[loc.clamp_min(0)], 0.0)
    return comm.psum(rows, geom.axis)


def split_rows(flat: torch.Tensor, n: int, shade: bool, motion: bool):
    """(shade rows (n,16), motion rows (n,18)) viewing K13's flat output of
    n rows (the shade rows first), None for a part it does not hold."""
    k = 16 * n if shade else 0
    return (flat[:k].view(n, 16) if shade else None,
            flat[k:].view(n, 18) if motion else None)


def sample_packed_across(atlas: tex.TextureAtlas, resource: torch.Tensor, uv: torch.Tensor,
                         axis) -> torch.Tensor:
    """``tex.sample_packed`` over an atlas banded over the gp ``axis``
    (``dist.comm.Axis``): each rank's share of the taps
    (``tex.sample_packed_banded``), summed over the axis."""
    return comm.psum(tex.sample_packed_banded(atlas, resource, uv), axis)


def sample_environment(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect lookup. direction (R,3) unit -> (R,3) radiance."""
    d = direction
    u = 0.5 + torch.atan2(d[:, 2], d[:, 0]) / (2.0 * S.PI)
    v = torch.clamp(0.5 - torch.asin(torch.clamp(d[:, 1], -1.0, 1.0)) / S.PI, 0.0, 1.0)
    he, we = env_map.shape[0], env_map.shape[1]
    x = u * we - 0.5
    y = v * he - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xi0 = torch.remainder(x0.to(torch.int32), we)
    xi1 = torch.remainder(x0.to(torch.int32) + 1, we)
    yi0 = torch.clamp(y0.to(torch.int32), 0, he - 1)
    yi1 = torch.clamp(y0.to(torch.int32) + 1, 0, he - 1)
    flat = env_map.reshape(-1, 3)
    c00 = flat[(yi0 * we + xi0).long()]
    c10 = flat[(yi0 * we + xi1).long()]
    c01 = flat[(yi1 * we + xi0).long()]
    c11 = flat[(yi1 * we + xi1).long()]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _project(camera: T.Camera, world_pos: torch.Tensor):
    """Screen projection used for motion vectors."""
    view = world_pos - camera.position
    sx = S.dot3(view, camera.right)
    sy = S.dot3(view, camera.up)
    depth = S.dot3(view, camera.forward)
    denom = torch.clamp(depth, min=0.001)
    return sx / denom, sy / denom, depth


def screen_motion(uniforms: T.FrameUniforms, mrow, u, v, width_f, height_f):
    """Motion in pixels (+Y down) and depth of the surface point at
    barycentrics (u, v) (each (P,1)) of the (P,18) motion rows."""
    w = 1.0 - u - v
    cam = uniforms.camera
    obj_pos_w = u * mrow[:, 3:6] + v * mrow[:, 6:9] + w * mrow[:, 0:3]
    prev_pos_w = u * mrow[:, 12:15] + v * mrow[:, 15:18] + w * mrow[:, 9:12]
    sx, sy, pdepth = _project(cam, obj_pos_w)
    psx, psy, _ = _project(uniforms.previous_camera, prev_pos_w)
    right_scale = torch.clamp(S.length(cam.right), min=1e-5)
    up_scale = torch.clamp(S.length(cam.up), min=1e-5)
    motion_px_x = (sx - psx) * (width_f / (2.0 * right_scale))
    motion_px_y = -((sy - psy) * (height_f / (2.0 * up_scale)))
    return torch.stack([motion_px_x, motion_px_y], -1), pdepth


def _power_pmf_cdf(lights: T.Lights):
    """The ``power`` light pick's pmf and cdf (luminance, times the area of
    an area light)."""
    lum = torch.clamp(lights.color.abs().sum(dim=1), min=1e-6)
    area = S.length(S.cross(lights.right, lights.up))
    wgt = torch.where(lights.type == T.LIGHT_TYPE_AREA, lum * torch.clamp(area, min=1e-6), lum)
    pmf = wgt / wgt.sum()
    return pmf, torch.cumsum(pmf, dim=0)


def _hit_normal(srow, u_b1, v_b1, w_b1, ray_d):
    """The hits' interpolated normals from their (P,16) shade rows at
    barycentrics (u, v, w) (each (P,1)); -ray_d where one degenerates."""
    nrm_raw = u_b1 * srow[:, 3:6] + v_b1 * srow[:, 6:9] + w_b1 * srow[:, 0:3]
    degenerate = S.length(nrm_raw) < 1e-10
    return _where3(degenerate, -ray_d, S.normalize(nrm_raw))


def _lod_base(fr: Frame, dist, ray_d, nrm, srow, mrow):
    """The ray cone's mip LOD base (log2 of its footprint in uv units) at
    path length ``dist``: the cone's radius grows with the path length; its
    footprint goes to uv units by the hit triangle's uv-area / world-area
    ratio (``mrow``: its (P,18) motion rows)."""
    e1w = mrow[:, 3:6] - mrow[:, 0:3]
    e2w = mrow[:, 6:9] - mrow[:, 0:3]
    world_area = 0.5 * S.length(S.cross(e1w, e2w))
    du1 = srow[:, 11:13] - srow[:, 9:11]
    du2 = srow[:, 13:15] - srow[:, 9:11]
    uv_area = 0.5 * (du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]).abs()
    cos_inc = torch.clamp(S.dot3(ray_d, nrm).abs(), min=0.25)
    footprint_w = dist * fr.pixel_angle / cos_inc
    footprint_uv = footprint_w * torch.sqrt(uv_area / torch.clamp(world_area, min=1e-12))
    return torch.log2(torch.clamp(footprint_uv, min=1e-8))


def _tex_coord(srow, u_b1, v_b1, w_b1):
    """The hits' texture coordinates: the barycentric blend of the shade
    rows' uvs (u uv1 + v uv2 + w uv0), y flipped."""
    tex_coord = u_b1 * srow[:, 11:13] + v_b1 * srow[:, 13:15] + w_b1 * srow[:, 9:11]
    return torch.stack([tex_coord[:, 0], 1.0 - tex_coord[:, 1]], dim=1)


def _hidx(fr: Frame, sidx: int) -> torch.Tensor:
    return fr.offsets + fr.base + sidx


# ---------------------------------------------------------------------------
# Plain versions (the port's torch-op wavefront body)
# ---------------------------------------------------------------------------

def sample_start_plain(fr: Frame, sidx: int, total: torch.Tensor,
                       prev: LaneState | None = None) -> LaneState:
    """K6's plain version: sample ``sidx``'s camera rays and fresh lane
    state (``total``: each lane's sample count; a lane at or past it starts
    dead). The G-buffer carries over from ``prev`` (zeros at sample 0)."""
    P = fr.pixel_x.shape[0]
    dev = fr.pixel_x.device
    f32 = torch.float32
    cam = fr.uniforms.camera
    hidx0 = _hidx(fr, sidx)
    rx = H.halton(hidx0, 0)
    ry = H.halton(hidx0, 1)
    u = (fr.pixel_x.to(f32) + rx) / fr.width_f * 2.0 - 1.0
    v = (fr.pixel_y.to(f32) + ry) / fr.height_f * 2.0 - 1.0
    ray_d = S.normalize(u[:, None] * cam.right + v[:, None] * cam.up + cam.forward)
    return LaneState(
        ray_o=cam.position.expand(P, 3), ray_d=ray_d,
        color=torch.ones((P, 3), dtype=f32, device=dev),
        accumulated=torch.zeros((P, 3), dtype=f32, device=dev),
        bounce=torch.zeros(P, dtype=torch.int32, device=dev),
        step=torch.zeros(P, dtype=torch.int32, device=dev),
        tpasses=torch.zeros(P, dtype=torch.int32, device=dev),
        # a lane past its own sample count neither adds radiance nor counts rays
        active=total > sidx,
        rays=torch.zeros(P, dtype=torch.int32, device=dev),
        prim_tri=torch.full((P,), -1, dtype=torch.int32, device=dev),
        prim_u=torch.zeros(P, dtype=f32, device=dev),
        prim_v=torch.zeros(P, dtype=f32, device=dev),
        cone_t=torch.zeros(P, dtype=f32, device=dev), **_gbuffer(fr, prev))


def _gbuffer(fr: Frame, prev: LaneState | None) -> dict:
    """A sample's G-buffer fields: ``prev``'s (they carry over), zeros at
    sample 0, none unless ``settings.enable_gbuffer``."""
    if not fr.settings.enable_gbuffer:
        return {}
    if prev is not None:
        return {k: getattr(prev, k) for k in GBUFFER_FIELDS}
    P = fr.pixel_x.shape[0]
    dev = fr.pixel_x.device
    return {k: torch.zeros((P, cols) if cols else (P,), dtype=dtype, device=dev)
            for k, (dtype, cols) in _STATE_LAYOUT.items() if k in GBUFFER_FIELDS}


def shade_hit_plain(fr: Frame, st: LaneState, hits: T.Hits, sidx: int,
                    rows: LaneRows | None = None):
    """K7's plain version: one iteration's body between the closest-hit and
    the any-hit traversal of sample ``sidx``, from the closest ``hits`` of
    the lanes ``st.active`` traced. Returns (the next state, the shadow
    rays); in a debug view the lanes retire at their first hit and the
    shadow rays are None (no any-hit traversal). ``rows``: a gp step's
    rows (``lane_rows``; the lane-row form), read at each lane's position,
    else the hits' rows are gathered here (``_tri_rows``, with its psums
    under gp)."""
    settings, statics, scene, geom = fr.settings, fr.statics, fr.scene, fr.geom
    if rows is not None:
        rows = at_lanes(rows)
    P = st.active.shape[0]
    dev = st.active.device
    f32 = torch.float32
    gax = geom.axis if settings.geometry_axis else None
    debug_mode = settings.debug_mode
    motion_view = debug_mode == T.DEBUG_MODE_MOTION
    is_sample0 = sidx == 0
    hidx = _hidx(fr, sidx)
    ray_o, ray_d, color, accumulated = st.ray_o, st.ray_d, st.color, st.accumulated
    bounce, step, tpasses, active = st.bounce, st.step, st.tpasses, st.active
    prim_tri, prim_u, prim_v, cone_t = st.prim_tri, st.prim_u, st.prim_v, st.cone_t
    gb = None if st.wrote_gb is None else {k: getattr(st, k) for k in GBUFFER_FIELDS}
    rays = st.rays + active.to(torch.int32)

    hit = hits.hit & active
    if statics.has_environment:
        missed = active & ~hit
        env = sample_environment(scene.env_map, ray_d) * scene.env_intensity
        accumulated = accumulated + _where3(missed, color * env, 0.0)
    active = active & hit

    tri = hits.triangle.clamp_min(0).long()
    srow = _tri_rows(geom.shade_rows, tri, geom) if rows is None else rows.shade
    res = srow[:, 15].to(torch.int32)
    world_point = ray_o + ray_d * hits.t[:, None]
    u_b1 = hits.u[:, None]
    v_b1 = hits.v[:, None]
    w_b1 = 1.0 - u_b1 - v_b1

    # --- primary hit record (bounce 0, sample 0) ----------------------------
    if is_sample0:
        primary = hit & (bounce == 0)
        prim_tri = torch.where(primary, hits.triangle, prim_tri)
        prim_u = torch.where(primary, hits.u, prim_u)
        prim_v = torch.where(primary, hits.v, prim_v)

    if settings.use_mipmaps or motion_view:
        mrow = _tri_rows(geom.motion_rows, tri, geom) if rows is None else rows.motion

    # --- surface normal ------------------------------------------------------
    nrm = _hit_normal(srow, u_b1, v_b1, w_b1, ray_d)

    # --- ray-cone mip LOD
    if settings.use_mipmaps:
        lod_base = _lod_base(fr, cone_t + torch.where(hit, hits.t, 0.0), ray_d, nrm, srow, mrow)
        cone_t = cone_t + torch.where(hit, hits.t, 0.0)

    # --- material + textures ---------------------------------------------------
    matrow = geom.mat_rows[res.long()]
    albedo = matrow[:, 0:3]
    flags = matrow[:, 12].to(torch.int32)
    tex_coord = _tex_coord(srow, u_b1, v_b1, w_b1)
    packed = []

    def tex_sample(map_type):
        if settings.use_mipmaps:
            return tex.sample_trilinear(scene.atlas, res, map_type, tex_coord, lod_base)
        if not packed:
            if rows is not None and rows.taps is not None:
                packed.append(rows.taps)
            elif gax is not None and scene.atlas.band_lo is not None:
                packed.append(sample_packed_across(scene.atlas, res, tex_coord, gax))
            else:
                packed.append(tex.sample_packed(scene.atlas, res, tex_coord))
        return tex.packed_map(packed[0], map_type)

    def has(bit):
        return (flags & bit) != 0

    base_sample = None
    if statics.any_map[tex.MAP_BASECOLOR]:
        base_sample = tex_sample(tex.MAP_BASECOLOR)
        albedo = _where3(has(T.MATERIAL_TEXTURE_BASECOLOR), albedo * base_sample, albedo)
    roughness = torch.ones(P, dtype=f32, device=dev)
    if statics.any_map[tex.MAP_ROUGHNESS]:
        s = tex_sample(tex.MAP_ROUGHNESS)[:, 0]
        roughness = torch.where(has(T.MATERIAL_TEXTURE_ROUGHNESS), s, roughness)
    metallic = torch.zeros(P, dtype=f32, device=dev)
    if statics.any_map[tex.MAP_METALLIC]:
        s = tex_sample(tex.MAP_METALLIC)[:, 0]
        metallic = torch.where(has(T.MATERIAL_TEXTURE_METALLIC), s, metallic)
    ao = torch.ones(P, dtype=f32, device=dev)
    if T.ENABLE_AO and statics.any_map[tex.MAP_AO]:
        s = tex_sample(tex.MAP_AO)[:, 0]
        ao = torch.where(has(T.MATERIAL_TEXTURE_AO), s, ao)
    opacity = torch.clamp(matrow[:, 11], 0.0, 1.0)
    if statics.any_map[tex.MAP_OPACITY]:
        s = tex_sample(tex.MAP_OPACITY)[:, 0]
        opacity = torch.where(has(T.MATERIAL_TEXTURE_OPACITY), opacity * s, opacity)
    emission = matrow[:, 6:9]
    if statics.any_map[tex.MAP_EMISSION]:
        s = tex_sample(tex.MAP_EMISSION)
        emission = _where3(has(T.MATERIAL_TEXTURE_EMISSION), s, emission)

    # --- debug views: the colour at the hit, then the lane retires -----------------
    if debug_mode != T.DEBUG_MODE_NONE:
        magenta = torch.tensor([1.0, 0.0, 1.0], dtype=f32, device=dev).expand(P, 3)
        if debug_mode == T.DEBUG_MODE_BASECOLOR:
            debug = (magenta if base_sample is None
                     else _where3(has(T.MATERIAL_TEXTURE_BASECOLOR), base_sample, magenta))
        elif debug_mode == T.DEBUG_MODE_NORMAL:
            debug = nrm * 0.5 + 0.5
            if statics.any_map[tex.MAP_NORMAL]:
                debug = _where3(has(T.MATERIAL_TEXTURE_NORMAL), tex_sample(tex.MAP_NORMAL), debug)
        elif debug_mode == T.DEBUG_MODE_ROUGHNESS:
            debug = roughness[:, None].expand(P, 3)
        elif debug_mode == T.DEBUG_MODE_METALLIC:
            debug = metallic[:, None].expand(P, 3)
        elif debug_mode == T.DEBUG_MODE_AO:
            debug = ao[:, None].expand(P, 3) if T.ENABLE_AO else magenta
        elif debug_mode == T.DEBUG_MODE_EMISSION:
            debug = emission
        else:  # the motion view: sample 0's motion (Raytracing.metal:342,482-487)
            if is_sample0:
                now, _ = screen_motion(fr.uniforms, mrow, u_b1, v_b1, fr.width_f, fr.height_f)
                mp = _where3(hit, now, fr.prev_motion)
            else:
                mp = _where3(fr.had0, fr.motion0, fr.prev_motion)
            scaled = torch.clamp(mp * 0.05, -1.0, 1.0)
            mag = torch.clamp(S.length2(mp) * 0.1, 0.0, 1.0)
            debug = torch.stack([scaled[:, 0] * 0.5 + 0.5, scaled[:, 1] * 0.5 + 0.5, mag], -1)
        accumulated = _where3(hit, debug, accumulated)
        return st._replace(accumulated=accumulated, active=torch.zeros_like(active), rays=rays,
                           prim_tri=prim_tri, prim_u=prim_u, prim_v=prim_v, cone_t=cone_t), None

    # --- normal mapping ------------------------------------------------------------
    shading_nrm = nrm
    if statics.any_map[tex.MAP_NORMAL]:
        if not (settings.use_mipmaps or motion_view):
            mrow = _tri_rows(geom.motion_rows, tri, geom) if rows is None else rows.motion
        valid_tb, tangent, _ = S.tangent_basis_rows(
            mrow[:, 0:3], mrow[:, 3:6], mrow[:, 6:9],
            srow[:, 9:11], srow[:, 11:13], srow[:, 13:15])
        world_t = S.normalize(tangent - nrm * S.dot3(tangent, nrm)[:, None])
        world_b = S.normalize(S.cross(nrm, world_t))
        nmap = tex_sample(tex.MAP_NORMAL) * 2.0 - 1.0
        mapped = S.normalize(nmap[:, 0:1] * world_t + nmap[:, 1:2] * world_b
                             + nmap[:, 2:3] * nrm)
        shading_nrm = _where3(has(T.MATERIAL_TEXTURE_NORMAL) & valid_tb, mapped, nrm)

    # --- G-buffer: sample 0's first hit, before the glass branch -------------------
    if gb is not None and is_sample0:
        write_gb = hit & ~gb["wrote_gb"]
        m = metallic[:, None]
        gb["diffuse_albedo"] = _where3(write_gb, albedo * (1.0 - m), gb["diffuse_albedo"])
        gb["specular_albedo"] = _where3(write_gb, 0.04 + (albedo - 0.04) * m,
                                        gb["specular_albedo"])
        gb["normal"] = _where3(write_gb, shading_nrm * 0.5 + 0.5, gb["normal"])
        gb["roughness"] = torch.where(write_gb, torch.clamp(roughness, 0.0, 1.0),
                                      gb["roughness"])
        gb["wrote_gb"] = gb["wrote_gb"] | write_gb

    # --- glass / transparency branch ---------------------------------------------
    step0 = step
    qmc_cur, qmc_nxt = H.step_bases_pair(step0)
    skip_lighting = torch.zeros(P, dtype=torch.bool, device=dev)
    if statics.has_refraction:
        ior = torch.clamp(matrow[:, 10], min=1.0)
        clamped_op = torch.clamp(opacity, 0.0, 1.0)
        glass = hit & ((clamped_op < 0.999) | (ior > 1.01))
        N = shading_nrm
        I = ray_d
        cosi = torch.clamp(S.dot3(-I, N), -1.0, 1.0)
        inside = cosi < 0.0
        cosi = cosi.abs()
        N = _where3(inside, -N, N)
        one = torch.ones_like(ior)
        eta_i = torch.where(inside, ior, one)
        eta_t = torch.where(inside, one, ior)
        eta = eta_i / eta_t
        k = 1.0 - eta * eta * (1.0 - cosi * cosi)
        f0 = ((eta_t - eta_i) / (eta_t + eta_i)) ** 2
        F = f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cosi, 0.0, 1.0), 5.0)
        transmission = 1.0 - clamped_op
        reflect_w = F
        refract_w = (1.0 - F) * transmission
        total_w = torch.clamp(reflect_w + refract_w, min=1e-4)
        reflect_prob = reflect_w / total_w
        choice = H.halton_base(hidx, qmc_cur["transparency"], H.STEP_MAX_DIGITS)
        do_reflect = (k < 0.0) | (choice < reflect_prob)
        reflect_dir = S.normalize(I - 2.0 * S.dot3(I, N)[:, None] * N)
        cos_t = torch.sqrt(torch.clamp(k, min=0.0))
        refract_dir = S.normalize(eta[:, None] * I + (eta * cosi - cos_t)[:, None] * N)
        new_dir = _where3(do_reflect, reflect_dir, refract_dir)
        new_origin = world_point + new_dir * 1e-3
        new_color = _where3(do_reflect, color * total_w[:, None],
                            color * total_w[:, None] * albedo)
        ray_d = _where3(glass, new_dir, ray_d)
        ray_o = _where3(glass, new_origin, ray_o)
        color = _where3(glass, new_color, color)
        consume_bounce = ~(glass & ~do_reflect)
        skip_lighting = glass
        g_bounce = torch.where(consume_bounce, bounce + 1, bounce)
        g_tp = torch.where(consume_bounce, 0, tpasses + 1)
        overflow = ~consume_bounce & (g_tp > settings.max_bounces)
        g_bounce = torch.where(overflow, g_bounce + 1, g_bounce)
        g_tp = torch.where(overflow, 0, g_tp)
        step = torch.where(glass, step + 1, step)
        bounce = torch.where(glass, g_bounce, bounce)
        tpasses = torch.where(glass, g_tp, tpasses)

    lit = active & ~skip_lighting
    accumulated = accumulated + _where3(lit, color * emission, 0.0)

    adv = step > step0  # glass lanes advanced one step

    def qmc(name):
        return H.halton_base(hidx, torch.where(adv, qmc_nxt[name], qmc_cur[name]),
                             H.STEP_MAX_DIGITS)

    light_sample = qmc("light_pick")
    u_area = torch.stack([qmc("area_a"), qmc("area_b")], -1)
    u_b = torch.stack([qmc("bounce_x"), qmc("bounce_y")], -1)

    # --- pick 1 of N lights ----------------------------------------------------------
    n_lights = statics.n_lights
    lights = scene.lights
    if settings.light_sampling == "power" and n_lights > 1:
        pmf, cdf = _power_pmf_cdf(lights)
        light_index = torch.searchsorted(cdf, light_sample).clamp(0, n_lights - 1)
        light_weight = (1.0 / torch.clamp(pmf[light_index], min=1e-8))[:, None]
    else:
        light_index = torch.clamp((light_sample * n_lights).to(torch.int32),
                                  max=n_lights - 1)
        light_weight = float(n_lights)
    l_dir, l_col, l_dist = S.evaluate_light(lights, light_index, u_area, world_point)
    l_col = l_col * light_weight

    # --- shading ------------------------------------------------------------------------
    shadow_o = world_point + nrm * 1e-3
    shadow_dist = l_dist - 1e-3
    if settings.shading_mode == T.SHADING_MODE_LEGACY:
        L = S.normalize(l_dir)
        n_dot_l = S.saturate(S.dot3(shading_nrm, L))
        legacy_color = color * albedo
        dead_before = S.length(legacy_color) < 0.001
        active = active & ~(lit & dead_before)
        lit = lit & ~dead_before
        need_shadow = lit & (S.length(l_col) > 0.0001) & (n_dot_l > 0.0)
        contrib = legacy_color * l_col * n_dot_l[:, None]
    else:
        perceptual_roughness = torch.clamp(roughness, 0.04, 1.0)
        alpha = perceptual_roughness * perceptual_roughness
        F0 = 0.04 + (albedo - 0.04) * metallic[:, None]
        V = S.normalize(-ray_d)
        has_light = S.length(l_col) > 0.0001
        L = S.normalize(l_dir)
        Hv = S.normalize(V + L)
        n_dot_l = S.saturate(S.dot3(shading_nrm, L))
        n_dot_v = S.saturate(S.dot3(shading_nrm, V))
        n_dot_h = S.saturate(S.dot3(shading_nrm, Hv))
        v_dot_h = S.saturate(S.dot3(V, Hv))
        Fr = S.fresnel_schlick(v_dot_h, F0)
        D = S.distribution_ggx(n_dot_h, alpha)
        kk = perceptual_roughness + 1.0
        kk = (kk * kk) / 8.0
        G = S.geometry_smith(n_dot_v, n_dot_l, kk)
        specular = (D * G)[:, None] * Fr / torch.clamp(4.0 * n_dot_v * n_dot_l, min=1e-4)[:, None]
        kD = (1.0 - Fr) * (1.0 - metallic)[:, None]
        diffuse = kD * albedo / S.PI
        direct = (diffuse + specular) * l_col * n_dot_l[:, None]
        need_shadow = lit & has_light
        contrib = color * direct

    rays = rays + need_shadow.to(torch.int32)

    # --- after the shadow ray: throughput, dead lanes, the next bounce ----------------
    # (reads neither the occlusion nor the radiance sum, so it runs before
    # the any-hit traversal)
    if settings.shading_mode == T.SHADING_MODE_LEGACY:
        new_color = legacy_color * ao[:, None]
    else:
        # throughput: diffuse only, AO on indirect
        new_color = color * albedo * ((1.0 - metallic) * ao)[:, None]
    color = _where3(lit, new_color, color)
    dead = S.length(color) < 0.001
    active = active & ~(lit & dead)
    lit = lit & ~dead

    # --- cosine-hemisphere bounce ---------------------------------------------------------
    bounce_dir = S.align_hemisphere_with_normal(S.sample_cosine_hemisphere(u_b), shading_nrm)
    ray_o = _where3(lit, world_point + nrm * 1e-3, ray_o)
    ray_d = _where3(lit, bounce_dir, ray_d)
    step = torch.where(lit, step + 1, step)
    bounce = torch.where(lit, bounce + 1, bounce)
    tpasses = torch.where(lit, 0, tpasses)
    active = active & (bounce < settings.max_bounces)

    nxt = LaneState(ray_o, ray_d, color, accumulated, bounce, step, tpasses, active, rays,
                    prim_tri, prim_u, prim_v, cone_t, **(gb or {}))
    return nxt, Shadow(shadow_o, l_dir, shadow_dist, contrib, need_shadow)


def resolve_shadow_plain(st: LaneState, shadow: Shadow, occluded: torch.Tensor) -> LaneState:
    """K8's plain version: the shadow rays' radiance where they are live and
    not ``occluded``."""
    return st._replace(accumulated=st.accumulated
                       + _where3(shadow.need & ~occluded, shadow.contrib, 0.0))


def shade_hit_listed_plain(fr: Frame, st: LaneState, hits: T.Hits, sidx: int, wv: Wave,
                           rows: LaneRows | None = None):
    """K7's plain version: ``wv``'s pending shadow rays resolved
    (``resolve_shadow_plain``), then ``shade_hit_plain`` (with the gp
    step's per-lane ``rows`` where given: the lane-row form), over every
    lane; the next step's lanes are those live or holding a shadow ray
    (``active | need``). Returns (the next state, the next ``Wave``, the
    live-lane count as a 0-d int32 tensor)."""
    if wv.shadow is not None:
        st = resolve_shadow_plain(st, wv.shadow, wv.occluded)
    st, sh = shade_hit_plain(fr, st, hits, sidx, rows)
    keep = st.active if sh is None else st.active | sh.need
    return st, Wave(sh, None, keep, wv.steps + 1, wv.buf), st.active.sum(dtype=torch.int32)


def resolve_shadow_listed_plain(st: LaneState, wv: Wave) -> LaneState:
    """K8's plain version at a sample's end: ``wv``'s pending shadow rays
    resolved (``resolve_shadow_plain``), if any."""
    return st if wv.shadow is None else resolve_shadow_plain(st, wv.shadow, wv.occluded)


def gp_rows_plain(geom, ids: torch.Tensor, live: torch.Tensor | None, shade: bool = True,
                  motion: bool = False):
    """K13's plain version, the local half of ``_tri_rows`` over the lanes
    that are ``live`` (every lane when None), compacted in lane order: each
    lane's position ``pos`` (the live lanes before it, from
    ``torch.cumsum``; -1 where dead) and its inverse ``lane_of``
    (``torch.nonzero``), and per live lane with a hit (``ids`` >= 0, global
    triangle ids) on a triangle this rank's shard holds (``geom.g2l``) its
    shade row and/or motion row from the shard's tables at its position,
    zeros for the other live lanes. Returns (rows, pos, lane_of): the rows
    flat, the (n,16) shade rows first, then the (n,18) motion rows
    (``split_rows`` views them), for one psum; pos (P,) and lane_of (n,)
    int32."""
    if live is None:
        live = torch.ones(ids.shape[0], dtype=torch.bool, device=ids.device)
    pos, lane_of = gp_scan_plain(live)
    idl = ids[lane_of.long()]
    loc = torch.where(idl >= 0, geom.g2l[idl.clamp_min(0).long()], -1).long()
    mine = (loc >= 0)[:, None]
    parts = [torch.where(mine, table[loc.clamp_min(0)], 0.0).reshape(-1)
             for table, on in ((geom.shade_rows, shade), (geom.motion_rows, motion)) if on]
    return torch.cat(parts), pos, lane_of


def gp_scan_plain(live: torch.Tensor):
    """K13's map alone (a gp step's scan, before its hit combine): each
    ``live`` lane's position ``pos`` (the live lanes before it, from
    ``torch.cumsum``; -1 where dead) and its inverse ``lane_of``
    (``torch.nonzero``); (P,) and (n,) int32."""
    pos = torch.where(live, torch.cumsum(live, 0, dtype=torch.int32) - 1, -1).to(torch.int32)
    return pos, torch.nonzero(live).squeeze(1).to(torch.int32)


def _plus_zero_bits(x: torch.Tensor, canon: bool) -> torch.Tensor:
    """The int32 bits of float32 ``x``, -0.0 as +0.0 where ``canon``."""
    b = x.view(torch.int32)
    return torch.where(b == -(1 << 31), 0, b) if canon else b


def hit_keys_of(t: torch.Tensor, tri: torch.Tensor, rank: int, canon: bool) -> torch.Tensor:
    """The int64 key of each hit (``csrc/wavefront.cu:hit_key``):
    ``(bits(t) << 32) | r'``, r' = ``rank`` where ``tri`` >= 0, else
    ``NO_WINNER``; -0.0 as +0.0 where ``canon`` (the axis has more than one
    rank). A hit's t is >= 0 or +inf, so the keys' order is (t, r')'s and
    their minimum over gp holds ``combine_hits_across``'s ``t_min`` and
    winning rank."""
    hi = _plus_zero_bits(t.contiguous(), canon).to(torch.int64)
    return (hi << 32) | torch.where(tri >= 0, rank, NO_WINNER).to(torch.int64)


def gp_hit_keys_plain(t: torch.Tensor, tri: torch.Tensor, lane_of: torch.Tensor,
                      axis) -> torch.Tensor:
    """K15's plain version: the key (``hit_keys_of``) of each of a gp
    step's n rows, from its lane's (``lane_of``) t and triangle in the
    closest-hit record ((P,) each), this rank's index on the gp ``axis``
    (``dist.comm.Axis``). (n,) int64."""
    idx = lane_of.long()
    return hit_keys_of(t[idx], tri[idx], axis.index, axis.size > 1)


def gp_occluded_rows_plain(occluded: torch.Tensor, lane_of: torch.Tensor) -> torch.Tensor:
    """K15's second form, plain: each row's lane's occlusion ((P,) bool) as
    (n,) uint8, for the pmax over gp."""
    return occluded[lane_of.long()].to(torch.uint8)


def gp_gather_plain(geom, t: torch.Tensor, tri: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    keys: torch.Tensor, lane_of: torch.Tensor, shade: bool = True,
                    motion: bool = False) -> torch.Tensor:
    """K13's gather, plain: per row j of a gp step's map (``lane_of``, (n,)),
    whether this rank won the hit combine (its own key, ``hit_keys_of`` on
    the record ``t``, ``tri`` at the lane, equals ``keys[j]``, the keys'
    minimum over gp, and its triangle is >= 0); the winner writes the
    payload (triangle + 1, the bits of u and v) and its shard's shade and/or
    motion rows of the triangle (``geom.g2l``), the other ranks zeros. Over
    more than one rank -0.0 is written +0.0, as a float psum with zeros
    makes it. Returns the rows flat, the (n,16) shade rows, then the (n,18)
    motion rows, then the (n, ``PAYLOAD_COLS``) payload, all as float32 (the
    payload's int32 bits), for one int32 psum over gp."""
    axis = geom.axis
    canon = axis.size > 1
    idx = lane_of.long()
    ti = tri[idx]
    win = (ti >= 0) & (hit_keys_of(t[idx], ti, axis.index, canon) == keys)
    loc = torch.where(win, geom.g2l[ti.clamp_min(0).long()], -1).long()
    mine = (loc >= 0)[:, None]
    parts = [_plus_zero_bits(torch.where(mine, table[loc.clamp_min(0)], 0.0), canon).reshape(-1)
             for table, on in ((geom.shade_rows, shade), (geom.motion_rows, motion)) if on]
    payload = torch.stack([torch.where(win, ti + 1, 0),
                           torch.where(win, _plus_zero_bits(u[idx], canon), 0),
                           torch.where(win, _plus_zero_bits(v[idx], canon), 0)], 1)
    return torch.cat(parts + [payload.reshape(-1)]).view(torch.float32)


def gp_lane_unpack_plain(keys: torch.Tensor, payload: torch.Tensor, lane_of: torch.Tensor,
                         t: torch.Tensor, tri: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """K16's plain version: the combined hit of each of a gp step's rows
    into the closest-hit record at its lane (``lane_of``), in place: t from
    the reduced key's high word, the triangle from the summed payload
    ((n, ``PAYLOAD_COLS``) int32) less one, u and v from its bits."""
    idx = lane_of.long()
    t[idx] = (keys >> 32).to(torch.int32).view(torch.float32)
    tri[idx] = payload[:, 0] - 1
    u[idx] = payload[:, 1].view(torch.float32)
    v[idx] = payload[:, 2].view(torch.float32)


def gp_occluded_lanes_plain(occ: torch.Tensor, lane_of: torch.Tensor, occluded: torch.Tensor):
    """K16's second form, plain: each row's occlusion reduced over gp
    ((n,) uint8) into its lane of ``occluded`` ((P,) bool), in place."""
    occluded[lane_of.long()] = occ != 0


def banded_taps_plain(atlas: tex.TextureAtlas, srow: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor, lane_of: torch.Tensor) -> torch.Tensor:
    """K14's plain version: this rank's share of the packed sample of each
    of K13's n rows on a gp-banded ``atlas`` (``tex.sample_packed_banded``),
    at the texture coordinate of its (n,16) shade row ``srow`` and its
    lane's (``lane_of``, (n,)) barycentrics ``u``, ``v`` ((P,) each), as
    ``shade_hit_plain`` makes them. (n,16) f32."""
    idx = lane_of.long()
    u_b1, v_b1 = u[idx][:, None], v[idx][:, None]
    w_b1 = 1.0 - u_b1 - v_b1
    return tex.sample_packed_banded(atlas, srow[:, 15].to(torch.int32),
                                    _tex_coord(srow, u_b1, v_b1, w_b1))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(_ptr(t) for t in ts))


def _cuda_route(what: str, fr: Frame) -> torch.device:
    dev = fr.pixel_x.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if fr.camera is None or fr.lights is None or fr.step_bases is None:
        raise ValueError(f"{what}: the frame was made for the plain route, or not by "
                         "make_frame")
    return dev


def _check_state(what: str, st: LaneState, P: int, dev, gbuffer: bool):
    for name, (dtype, cols) in _STATE_LAYOUT.items():
        t = getattr(st, name)
        if name in GBUFFER_FIELDS and not gbuffer:
            continue
        if t is None:
            raise ValueError(f"{what}: the lane state has no {name}")
        _check(what, name, t, dtype, (P, cols) if cols else (P,), dev)


def _lane_ptrs(st: LaneState):
    return _ptrs([getattr(st, k) for k in LaneState._fields])


def _frame_ptrs(fr: Frame, lane: LaneBuffers | None = None):
    """The kernels' ``Frame``; with the gp steps' row buffers ``lane`` (K7's
    lane-row form) K13's shade rows stand where the table's stood."""
    scene, geom = fr.scene, fr.geom
    shade = geom.shade_rows if lane is None else lane.flat
    return _ptrs([fr.pixel_x, fr.pixel_y, fr.offsets, fr.camera, fr.lights, shade,
                  geom.mat_rows, fr.step_bases, scene.env_map,
                  scene.env_intensity])


def _maps_ptrs(fr: Frame, lane: LaneBuffers | None = None):
    """K7's ``Maps``; with ``lane`` K14's taps (where it has them) stand
    where the packed atlas stood, and the motion rows, which follow a
    step's shade rows in ``lane.flat``, are addressed by the lane-row form
    itself (null here)."""
    atlas = fr.scene.atlas
    packed, motion = atlas.packed, fr.geom.motion_rows
    if lane is not None:
        motion = None
        if lane.taps is not None:
            packed = lane.taps
    return _ptrs([packed, atlas.packed_rects, atlas.texels4, atlas.rects, atlas.mip_rects,
                  atlas.n_levels, motion, fr.pixel_angle, fr.prev_camera,
                  fr.prev_motion, fr.had0, fr.motion0])


def _check_maps(what: str, fr: Frame, P: int, dev):
    """What K7's textured and debug instantiations read (``_maps_ptrs``):
    the atlas where the scene has maps (its packed texels, the float4 copy
    of its mip texels, ``texels4``, and its rects read as float4 and int4,
    so 16-byte aligned), the motion rows (read as float2,
    8-byte aligned) where mipmaps, a normal map or the motion view need the
    hit's vertices, the pixel angle with mipmaps, and the motion view's
    previous camera and per-lane motion."""
    s, st = fr.settings, fr.statics
    aligned = []
    if any(st.any_map):
        a = fr.scene.atlas
        if a.band_lo is not None and not s.geometry_axis:
            raise ValueError(f"{what}: a banded atlas needs geometry sharding (its taps come from "
                             "K14 and a psum over gp)")
        R = a.packed_rects.shape[0]
        _check(what, "atlas.packed", a.packed, torch.float32,
               (a.packed.shape[0], a.packed.shape[1], tex.PACKED_C), dev)
        _check(what, "atlas.packed_rects", a.packed_rects, torch.int32, (R, 4), dev)
        if a.texels4 is None:
            raise ValueError(f"{what}: the atlas has no texels4 (texture.with_texels4)")
        _check(what, "atlas.texels4", a.texels4, torch.float32, (a.height, a.width, 4), dev)
        _check(what, "atlas.rects", a.rects, torch.int32, (R, tex.N_MAP_TYPES, 4), dev)
        _check(what, "atlas.mip_rects", a.mip_rects, torch.int32,
               (R, tex.N_MAP_TYPES, tex.MAX_MIPS, 4), dev)
        _check(what, "atlas.n_levels", a.n_levels, torch.int32, (R, tex.N_MAP_TYPES), dev)
        if fr.geom.mat_rows.shape[0] > R:
            raise ValueError(f"{what}: {fr.geom.mat_rows.shape[0]} materials for an atlas of "
                             f"{R} resources")
        aligned += [("atlas.packed", a.packed, 16), ("atlas.packed_rects", a.packed_rects, 16),
                    ("atlas.texels4", a.texels4, 16),
                    ("atlas.rects", a.rects, 16), ("atlas.mip_rects", a.mip_rects, 16)]
    motion = s.debug_mode == T.DEBUG_MODE_MOTION
    if needs_motion_rows(s, st):
        m = fr.geom.motion_rows
        _check(what, "motion_rows", m, torch.float32, (fr.geom.shade_rows.shape[0], 18), dev)
        aligned.append(("motion_rows", m, 8))
    if s.use_mipmaps:
        if fr.pixel_angle is None:
            raise ValueError(f"{what}: mipmaps need the frame's pixel_angle")
        _check(what, "pixel_angle", fr.pixel_angle, torch.float32, (), dev)
    if motion:
        if fr.prev_camera is None:
            raise ValueError(f"{what}: the motion view needs the frame's prev_camera (make_frame)")
        _check(what, "prev_camera", fr.prev_camera, torch.float32, (12,), dev)
        _check(what, "prev_motion", fr.prev_motion, torch.float32, (P, 2), dev)
        if (fr.had0 is None) != (fr.motion0 is None):
            raise ValueError(f"{what}: the frame has one of had0 and motion0")
        if fr.had0 is not None:
            _check(what, "had0", fr.had0, torch.bool, (P,), dev)
            _check(what, "motion0", fr.motion0, torch.float32, (P, 2), dev)
    for name, t, align in aligned:
        if t.data_ptr() % align:
            raise ValueError(f"{what}: {name} must be {align}-byte aligned")


def _check_frame(what: str, fr: Frame, P: int, dev, rows: bool = False):
    for name in ("pixel_x", "pixel_y", "offsets"):
        _check(what, name, getattr(fr, name), torch.int32, (P,), dev)
    _check(what, "camera", fr.camera, torch.float32, (12,), dev)
    _check(what, "step_bases", fr.step_bases, torch.int32, H._STEP_BASES_PAIR.shape, dev)
    n_lights = fr.lights.shape[0]
    if n_lights < 1 or n_lights != fr.statics.n_lights:
        raise ValueError(f"{what}: the light table has {n_lights} rows for "
                         f"{fr.statics.n_lights} lights")
    _check(what, "lights", fr.lights, torch.float32, (n_lights, LIGHT_COLS), dev)
    g = fr.geom
    _check(what, "shade_rows", g.shade_rows, torch.float32, (g.shade_rows.shape[0], 16), dev)
    _check(what, "mat_rows", g.mat_rows, torch.float32, (g.mat_rows.shape[0], 16), dev)
    env = fr.scene.env_map
    _check(what, "env_map", env, torch.float32, (env.shape[0], env.shape[1], 3), dev)
    _check(what, "env_intensity", fr.scene.env_intensity, torch.float32, (), dev)
    if rows:  # K7 reads them as float4
        for name, t in (("shade_rows", g.shade_rows), ("mat_rows", g.mat_rows)):
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be 16-byte aligned (its rows are read as "
                                 "float4)")
    if fr.tri_base is not None:
        _check(what, "tri_base", fr.tri_base, torch.int32, (fr.tri_base.shape[0],), dev)
    if fr.settings.geometry_axis:
        if g.g2l is None or g.axis is None:
            raise ValueError(f"{what}: geometry_axis needs the shard geometry's g2l and axis")
        if fr.tri_base is not None:
            raise ValueError(f"{what}: a gp step traces a shard's flat table (no tri_base)")
        _check(what, "g2l", g.g2l, torch.int32, (g.g2l.shape[0],), dev)
    if rows:
        _check_maps(what, fr, P, dev)


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def gp_rows(geom, ids: torch.Tensor, live: torch.Tensor | None, shade: bool = True,
            motion: bool = False, n_live: int | None = None, out: torch.Tensor | None = None,
            pos: torch.Tensor | None = None, lane_of: torch.Tensor | None = None,
            counts: torch.Tensor | None = None):
    """The live lanes' map and rows from this rank's shard (see
    ``gp_rows_plain``): (rows, pos, lane_of), the rows flat, the shade rows
    then the motion rows of the ``n_live`` live lanes (the caller's count of
    ``live``; every lane when ``live`` is None). CPU tensors take the plain
    version, and raise where ``n_live`` is not its count; CUDA tensors
    launch K13, into ``out``, ``pos``, ``lane_of`` (at least ``n_live``
    long; its first ``n_live`` returned) and its scratch ``counts`` (a
    ``GP_TILE``-lane tile each) where given."""
    P = ids.shape[0]
    if live is None:
        n_live = P if n_live is None else n_live
    if n_live is None:
        raise ValueError("gp_rows: the live lanes' count is needed (n_live)")
    if ids.device.type == "cpu":
        res = gp_rows_plain(geom, ids, live, shade, motion)
        if res[2].shape[0] != n_live:
            raise ValueError(f"gp_rows: {res[2].shape[0]} live lanes, the caller counted {n_live}")
        return res
    what = "gp_rows"
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    _check(what, "ids", ids, torch.int32, (P,), dev)
    if live is not None:
        _check(what, "live", live, torch.bool, (P,), dev)
    if not 0 <= n_live <= P:
        raise ValueError(f"{what}: {n_live} live lanes of {P}")
    g2l = geom.g2l
    if g2l is None:
        raise ValueError(f"{what}: the geometry is not a shard's (no g2l)")
    _check(what, "g2l", g2l, torch.int32, (g2l.shape[0],), dev)
    n_local = geom.shade_rows.shape[0]
    tables = []
    if shade:  # read as float4
        tables.append(("shade_rows", geom.shade_rows, 16, 16))
    if motion:  # read as float2
        tables.append(("motion_rows", geom.motion_rows, 18, 8))
    if not tables:
        raise ValueError(f"{what}: neither shade nor motion rows asked for")
    for name, t, cols, align in tables:
        _check(what, name, t, torch.float32, (n_local, cols), dev)
        if t.data_ptr() % align:
            raise ValueError(f"{what}: {name} must be {align}-byte aligned")
    n = n_live * sum(cols for _, _, cols, _ in tables)
    i32 = torch.int32
    tiles = -(-P // GP_TILE)
    out = torch.empty(n, dtype=torch.float32, device=dev) if out is None else out
    pos = torch.empty(P, dtype=i32, device=dev) if pos is None else pos
    lane_of = torch.empty(P, dtype=i32, device=dev) if lane_of is None else lane_of
    counts = torch.empty(tiles, dtype=i32, device=dev) if counts is None else counts
    _check(what, "out", out, torch.float32, (n,), dev)
    _check(what, "pos", pos, i32, (P,), dev)
    if lane_of.shape[0] < n_live:
        raise ValueError(f"{what}: lane_of holds {lane_of.shape[0]} lanes, not {n_live}")
    _check(what, "lane_of", lane_of, i32, (lane_of.shape[0],), dev)
    _check(what, "counts", counts, i32, (counts.shape[0],), dev)
    if counts.shape[0] < tiles:
        raise ValueError(f"{what}: counts holds {counts.shape[0]} tiles, not {tiles}")
    if out.data_ptr() % 16:  # the shade rows written as float4
        raise ValueError(f"{what}: out must be 16-byte aligned")
    if P == 0:
        return out, pos, lane_of[:0]
    from . import build

    lib = build.load()
    so, mo = split_rows(out, n_live, shade, motion)
    rc = lib.mrt_gp_rows(_ptr(ids), _ptr(live), _ptr(g2l), _ptr(geom.shade_rows),
                         _ptr(geom.motion_rows), _ptr(counts), _ptr(pos), _ptr(lane_of),
                         _ptr(so), _ptr(mo), P, n_live, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    launches["gp_rows"] += 1
    return out, pos, lane_of[:n_live]


def _gp_device(what: str, t: torch.Tensor):
    """The card of a gp wrapper's CUDA tensor ``t`` (raises for another
    device type), and the kernel library."""
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    from . import build

    return dev, build.load()


def _launched(what: str, stage: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    launches[stage] += 1


def gp_scan(live: torch.Tensor, n_live: int, pos: torch.Tensor | None = None,
            lane_of: torch.Tensor | None = None, counts: torch.Tensor | None = None):
    """A gp step's map alone (see ``gp_scan_plain``): (pos, lane_of).
    CPU tensors take the plain version, and raise where ``n_live`` (the
    caller's count of ``live``) is not its count; CUDA tensors launch K13's
    count and scan (``gp_rows_count_kernel``, ``gp_rows_kernel`` without
    ids), into ``pos``, ``lane_of`` (at least ``n_live`` long; its first
    ``n_live`` returned) and ``counts`` where given."""
    P = live.shape[0]
    if live.device.type == "cpu":
        res = gp_scan_plain(live)
        if res[1].shape[0] != n_live:
            raise ValueError(f"gp_scan: {res[1].shape[0]} live lanes, the caller counted {n_live}")
        return res
    what = "gp_scan"
    dev, lib = _gp_device(what, live)
    _check(what, "live", live, torch.bool, (P,), dev)
    if not 0 <= n_live <= P:
        raise ValueError(f"{what}: {n_live} live lanes of {P}")
    i32 = torch.int32
    tiles = -(-P // GP_TILE)
    pos = torch.empty(P, dtype=i32, device=dev) if pos is None else pos
    lane_of = torch.empty(P, dtype=i32, device=dev) if lane_of is None else lane_of
    counts = torch.empty(tiles, dtype=i32, device=dev) if counts is None else counts
    _check(what, "pos", pos, i32, (P,), dev)
    if lane_of.shape[0] < n_live or counts.shape[0] < tiles:
        raise ValueError(f"{what}: lane_of holds {lane_of.shape[0]} lanes ({n_live} live), "
                         f"counts {counts.shape[0]} tiles ({tiles})")
    _check(what, "lane_of", lane_of, i32, (lane_of.shape[0],), dev)
    _check(what, "counts", counts, i32, (counts.shape[0],), dev)
    if P == 0:
        return pos, lane_of[:0]
    rc = lib.mrt_gp_rows(None, _ptr(live), None, None, None, _ptr(counts), _ptr(pos),
                         _ptr(lane_of), None, None, P, n_live, _stream(dev))
    _launched(what, "gp_rows", rc)
    return pos, lane_of[:n_live]


def _check_record(what: str, dev, P: int, **fields):
    for name, (t, dtype) in fields.items():
        _check(what, name, t, dtype, (P,), dev)


def gp_hit_keys(t: torch.Tensor, tri: torch.Tensor, lane_of: torch.Tensor, axis,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Each gp step row's hit key (see ``gp_hit_keys_plain``). CPU tensors
    take the plain version; CUDA tensors launch K15, into ``out`` where
    given."""
    if t.device.type == "cpu":
        return gp_hit_keys_plain(t, tri, lane_of, axis)
    what = "gp_hit_keys"
    dev, lib = _gp_device(what, t)
    P, n = t.shape[0], lane_of.shape[0]
    _check_record(what, dev, P, t=(t, torch.float32), tri=(tri, torch.int32))
    _check(what, "lane_of", lane_of, torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev) if out is None else out
    _check(what, "out", out, torch.int64, (n,), dev)
    if n == 0:
        return out
    rc = lib.mrt_gp_hit_keys(_ptr(t), _ptr(tri), None, _ptr(lane_of), _ptr(out), None, n,
                             axis.index, int(axis.size > 1), _stream(dev))
    _launched(what, "gp_hit_keys", rc)
    return out


def gp_occluded_rows(occluded: torch.Tensor, lane_of: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Each gp step row's occlusion as uint8 (see
    ``gp_occluded_rows_plain``). CPU tensors take the plain version; CUDA
    tensors launch K15's second form, into ``out`` where given."""
    if occluded.device.type == "cpu":
        return gp_occluded_rows_plain(occluded, lane_of)
    what = "gp_occluded_rows"
    dev, lib = _gp_device(what, occluded)
    n = lane_of.shape[0]
    _check(what, "occluded", occluded, torch.bool, (occluded.shape[0],), dev)
    _check(what, "lane_of", lane_of, torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.uint8, device=dev) if out is None else out
    _check(what, "out", out, torch.uint8, (n,), dev)
    if n == 0:
        return out
    rc = lib.mrt_gp_hit_keys(None, None, _ptr(occluded), _ptr(lane_of), None, _ptr(out), n, 0, 0,
                             _stream(dev))
    _launched(what, "gp_hit_keys", rc)
    return out


def gp_gather(geom, t: torch.Tensor, tri: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              keys: torch.Tensor, lane_of: torch.Tensor, shade: bool = True, motion: bool = False,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """The winner's payload and rows of each gp step row (see
    ``gp_gather_plain``). CPU tensors take the plain version; CUDA tensors
    launch K13's gather, into ``out`` (16-byte aligned) where given."""
    if t.device.type == "cpu":
        return gp_gather_plain(geom, t, tri, u, v, keys, lane_of, shade, motion)
    what = "gp_gather"
    dev, lib = _gp_device(what, t)
    P, n = t.shape[0], lane_of.shape[0]
    _check_record(what, dev, P, t=(t, torch.float32), tri=(tri, torch.int32),
                  u=(u, torch.float32), v=(v, torch.float32))
    _check(what, "keys", keys, torch.int64, (n,), dev)
    _check(what, "lane_of", lane_of, torch.int32, (n,), dev)
    g2l, n_local = geom.g2l, geom.shade_rows.shape[0]
    if g2l is None:
        raise ValueError(f"{what}: the geometry is not a shard's (no g2l)")
    _check(what, "g2l", g2l, torch.int32, (g2l.shape[0],), dev)
    tables = [("shade_rows", geom.shade_rows, 16, 16, shade),
              ("motion_rows", geom.motion_rows, 18, 8, motion)]  # read as float4, float2
    cols = 0
    for name, table, c, align, on in tables:
        if on:
            _check(what, name, table, torch.float32, (n_local, c), dev)
            if table.data_ptr() % align:
                raise ValueError(f"{what}: {name} must be {align}-byte aligned")
            cols += c
    size = n * (cols + PAYLOAD_COLS)
    out = torch.empty(size, dtype=torch.float32, device=dev) if out is None else out
    _check(what, "out", out, torch.float32, (size,), dev)
    if out.data_ptr() % 16:  # the shade rows written as float4
        raise ValueError(f"{what}: out must be 16-byte aligned")
    if n == 0:
        return out
    so, mo = split_rows(out[:n * cols], n, shade, motion)
    rc = lib.mrt_gp_gather(_ptr(t), _ptr(tri), _ptr(u), _ptr(v), _ptr(keys), _ptr(lane_of),
                           _ptr(g2l), _ptr(geom.shade_rows), _ptr(geom.motion_rows), _ptr(so),
                           _ptr(mo), _ptr(out[n * cols:]), n, geom.axis.index,
                           int(geom.axis.size > 1), _stream(dev))
    _launched(what, "gp_rows", rc)
    return out


def gp_lane_unpack(keys: torch.Tensor, payload: torch.Tensor, lane_of: torch.Tensor,
                   t: torch.Tensor, tri: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The combined hit of each gp step row into the closest-hit record at
    its lane, in place (see ``gp_lane_unpack_plain``). CPU tensors take the
    plain version; CUDA tensors launch K16."""
    if t.device.type == "cpu":
        return gp_lane_unpack_plain(keys, payload, lane_of, t, tri, u, v)
    what = "gp_lane_unpack"
    dev, lib = _gp_device(what, t)
    P, n = t.shape[0], lane_of.shape[0]
    _check_record(what, dev, P, t=(t, torch.float32), tri=(tri, torch.int32),
                  u=(u, torch.float32), v=(v, torch.float32))
    _check(what, "keys", keys, torch.int64, (n,), dev)
    _check(what, "payload", payload, torch.int32, (n, PAYLOAD_COLS), dev)
    _check(what, "lane_of", lane_of, torch.int32, (n,), dev)
    if n == 0:
        return None
    rc = lib.mrt_gp_lane_unpack(_ptr(keys), _ptr(payload), None, _ptr(lane_of), _ptr(t),
                                _ptr(tri), _ptr(u), _ptr(v), None, n, _stream(dev))
    _launched(what, "gp_lane_unpack", rc)
    return None


def gp_occluded_lanes(occ: torch.Tensor, lane_of: torch.Tensor, occluded: torch.Tensor):
    """Each gp step row's occlusion reduced over gp into its lane of
    ``occluded``, in place (see ``gp_occluded_lanes_plain``). CPU tensors
    take the plain version; CUDA tensors launch K16's second form."""
    if occluded.device.type == "cpu":
        return gp_occluded_lanes_plain(occ, lane_of, occluded)
    what = "gp_occluded_lanes"
    dev, lib = _gp_device(what, occluded)
    n = lane_of.shape[0]
    _check(what, "occluded", occluded, torch.bool, (occluded.shape[0],), dev)
    _check(what, "occ", occ, torch.uint8, (n,), dev)
    _check(what, "lane_of", lane_of, torch.int32, (n,), dev)
    if n == 0:
        return None
    rc = lib.mrt_gp_lane_unpack(None, None, _ptr(occ), _ptr(lane_of), None, None, None, None,
                                _ptr(occluded), n, _stream(dev))
    _launched(what, "gp_lane_unpack", rc)
    return None


def banded_taps(atlas: tex.TextureAtlas, srow: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                lane_of: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """This rank's share of the packed sample of each of K13's rows on a
    banded atlas (see ``banded_taps_plain``). CPU tensors take the plain
    version; CUDA tensors launch K14, into ``out`` where given."""
    if srow.device.type == "cpu":
        return banded_taps_plain(atlas, srow, u, v, lane_of)
    what = "banded_taps"
    dev = srow.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if atlas.band_lo is None:
        raise ValueError(f"{what}: the atlas is not banded")
    n = srow.shape[0]
    P = u.shape[0]
    _check(what, "srow", srow, torch.float32, (n, 16), dev)
    _check(what, "u", u, torch.float32, (P,), dev)
    _check(what, "v", v, torch.float32, (P,), dev)
    _check(what, "lane_of", lane_of, torch.int32, (n,), dev)
    band, rects = atlas.packed, atlas.packed_rects
    _check(what, "atlas.packed", band, torch.float32, (band.shape[0], band.shape[1], tex.PACKED_C),
           dev)
    _check(what, "atlas.packed_rects", rects, torch.int32, (rects.shape[0], 4), dev)
    if out is None:
        out = torch.empty((n, tex.PACKED_C), dtype=torch.float32, device=dev)
    _check(what, "out", out, torch.float32, (n, tex.PACKED_C), dev)
    for name, t in (("srow", srow), ("atlas.packed", band), ("atlas.packed_rects", rects),
                    ("out", out)):
        if t.data_ptr() % 16:  # read or written as float4 / int4
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if n == 0:
        return out
    from . import build

    lib = build.load()
    rc = lib.mrt_banded_taps(_ptr(srow), _ptr(u), _ptr(v), _ptr(lane_of), _ptr(rects), _ptr(band),
                             int(atlas.band_lo), band.shape[0], band.shape[1], _ptr(out), n,
                             _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    launches["banded_taps"] += 1
    return out


def gp_combine(geom, hits: traverse2.TraverseOut, live: torch.Tensor, n_live: int,
               motion: bool = False, lb: LaneBuffers | None = None):
    """A gp step's hit combine over its ``n_live`` lanes ``live`` (the
    caller's count), with its shade (and ``motion``) rows: K13's scan (the
    map), K15 (each row's key), an in-place ``pmin_`` over gp of the n_live
    keys, K13's gather (the winner's payload and rows, zeros elsewhere), one
    in-place int32 ``psum_`` of payload and rows together (each element has
    one nonzero contributor: exact), then K16, which writes the combined t,
    triangle, u and v into the closest-hit record ``hits`` at the live
    lanes, in place. Equal to ``render/wavefront.combine_hits_across`` and
    ``_tri_rows`` there, bit for bit (a -0.0 t aside, which it makes +0.0
    over more than one rank: the reference's float min leaves its sign to
    the backend). On the card into the buffers ``lb`` where given; on the
    CPU through the plain versions, with the same collectives. Every rank
    issues them with the same sizes: the rays, and so the live lanes and
    their map, are replicated over gp. Returns (rows, pos, lane_of): the
    rows flat as ``gp_gather_plain`` lays them out."""
    axis = geom.axis
    cols = 16 + 18 * motion
    kw = {} if lb is None else dict(pos=lb.pos, lane_of=lb.lane_of, counts=lb.counts)
    pos, lane_of = gp_scan(live, n_live, **kw)
    keys = gp_hit_keys(hits.t, hits.tri, lane_of, axis,
                       out=None if lb is None else lb.keys[:n_live])
    comm.pmin_(keys, axis)
    flat = gp_gather(geom, hits.t, hits.tri, hits.u, hits.v, keys, lane_of, True, motion,
                     out=None if lb is None else lb.flat[:n_live * (cols + PAYLOAD_COLS)])
    comm.psum_(flat.view(torch.int32), axis)
    payload = flat[n_live * cols:].view(torch.int32).view(n_live, PAYLOAD_COLS)
    gp_lane_unpack(keys, payload, lane_of, hits.t, hits.tri, hits.u, hits.v)
    return flat, pos, lane_of


def lane_rows(fr: Frame, st: LaneState, hits: traverse2.TraverseOut, wv: Wave,
              n_live: int) -> LaneRows:
    """One gp step's hit combine and rows for K7's lane-row form, over the
    ``n_live`` lanes ``st.active`` (the caller's count: the previous step's
    live-lane count, or at a sample's first step the lanes it traces):
    ``gp_combine`` on this rank's closest-hit record ``hits`` (combined in
    place at the live lanes), then on a banded atlas with maps K14 over the
    rows (u, v read at ``lane_of[j]`` in the combined record) and a second
    ``psum_``. On the card into ``wv``'s buffers (made once by
    ``make_wave``); on the CPU through the plain versions, with the same
    collectives."""
    s, statics, geom = fr.settings, fr.statics, fr.geom
    motion = needs_motion_rows(s, statics)
    lb = None if wv.buf is None else wv.buf.lane
    flat, pos, lane_of = gp_combine(geom, hits, st.active, n_live, motion, lb)
    shade, mrow = split_rows(flat[:n_live * (16 + 18 * motion)], n_live, True, motion)
    taps = None
    if needs_lane_taps(s, statics, fr.scene.atlas.band_lo is not None):
        taps = banded_taps(fr.scene.atlas, shade, hits.u, hits.v, lane_of,
                           out=None if lb is None else lb.taps[:n_live])
        comm.psum_(taps, geom.axis)
    return LaneRows(shade, mrow, taps, pos, lane_of)


def lane_occluded(occluded: torch.Tensor, lane_of: torch.Tensor, axis,
                  wv: Wave | None = None) -> torch.Tensor:
    """The occlusion of a gp step's shadow rays over the gp ``axis``: they
    come from the lanes it shaded, its live lanes (``lane_of``, the map of
    ``lane_rows``), so K15's second form gathers theirs, an in-place
    ``pmax_`` of n_live uint8 reduces it, and K16's second form writes it
    back into ``occluded`` ((P,) bool, in place; the other lanes keep this
    rank's, which nothing reads). On the card into ``wv``'s buffer; an axis
    of one rank reduces nothing. Returns ``occluded``."""
    if axis.size == 1:
        return occluded
    lb = None if wv is None or wv.buf is None else wv.buf.lane
    occ = gp_occluded_rows(occluded, lane_of,
                           out=None if lb is None else lb.occ[:lane_of.shape[0]])
    comm.pmax_(occ, axis)
    gp_occluded_lanes(occ, lane_of, occluded)
    return occluded


def gp_motion_rows(geom, ids: torch.Tensor) -> torch.Tensor:
    """(P,18) motion rows of the global triangle ``ids`` (-1: none, zeros)
    under geometry sharding: K13 (its plain version on the CPU) over every
    lane, and a psum over gp (the depth and motion of sample 0's first
    hits)."""
    flat, _, _ = gp_rows(geom, ids, None, shade=False, motion=True)
    return comm.psum_(flat, geom.axis).view(ids.shape[0], 18)


def _hbase(fr: Frame, sidx: int) -> int:
    """``base + sidx`` as the int32 the plain version's ``offsets + base +
    sidx`` adds (wrapping)."""
    x = (fr.base + sidx) & 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def sample_start(fr: Frame, sidx: int, total: torch.Tensor,
                 prev: LaneState | None = None) -> LaneState:
    """Sample ``sidx``'s camera rays and fresh lane state (see
    ``sample_start_plain``). CPU tensors take the plain version; CUDA
    tensors launch K6."""
    if fr.pixel_x.device.type == "cpu":
        return sample_start_plain(fr, sidx, total, prev)
    what = "sample_start"
    dev = _cuda_route(what, fr)
    P = fr.pixel_x.shape[0]
    _check_frame(what, fr, P, dev)
    _check(what, "total", total, torch.int32, (P,), dev)
    st = LaneState(**{k: torch.empty((P, cols) if cols else (P,), dtype=dtype, device=dev)
                      for k, (dtype, cols) in _STATE_LAYOUT.items() if k not in GBUFFER_FIELDS},
                   **_gbuffer(fr, prev))
    _check_state(what, st, P, dev, fr.settings.enable_gbuffer)
    if P == 0:
        return st
    from . import build

    lib = build.load()
    rc = lib.mrt_sample_start(_lane_ptrs(st), _frame_ptrs(fr), _ptr(total), P,
                              _hbase(fr, sidx), sidx, float(fr.settings.width),
                              float(fr.settings.height), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    launches["sample_start"] += 1
    return st


def _flags(fr: Frame, sidx: int) -> int:
    s, st = fr.settings, fr.statics
    return ((sidx == 0) | (bool(s.enable_gbuffer) << 1) | (bool(st.has_refraction) << 2)
            | (bool(st.has_environment) << 3) | ((s.shading_mode == T.SHADING_MODE_LEGACY) << 4)
            | ((s.light_sampling == "power" and st.n_lights > 1) << 5) | (bool(T.ENABLE_AO) << 7))


def packed_groups(map_type: int) -> int:
    """The float4 groups of the packed texel that map ``map_type`` reads
    (bit q: channels 4q..4q+3; ``texture._PACKED_SLICE``)."""
    c0, cw = tex._PACKED_SLICE[map_type]
    return sum(1 << q for q in range(tex.PACKED_C // 4) if c0 < 4 * q + 4 and 4 * q < c0 + cw)


def map_groups(any_map) -> int:
    """K7's ``MapsInfo.map_groups``: in bits 4m..4m+3 the packed groups of
    map m (``packed_groups``) where some resource has it (``any_map[m]``,
    ``SceneStatics.any_map``), else 0."""
    return sum(packed_groups(m) << (4 * m) for m, on in enumerate(any_map) if on)


# each map's material texture bit (core/types.py:MATERIAL_TEXTURE_*)
_MAP_BITS = {tex.MAP_BASECOLOR: T.MATERIAL_TEXTURE_BASECOLOR,
             tex.MAP_NORMAL: T.MATERIAL_TEXTURE_NORMAL,
             tex.MAP_ROUGHNESS: T.MATERIAL_TEXTURE_ROUGHNESS,
             tex.MAP_METALLIC: T.MATERIAL_TEXTURE_METALLIC, tex.MAP_AO: T.MATERIAL_TEXTURE_AO,
             tex.MAP_OPACITY: T.MATERIAL_TEXTURE_OPACITY,
             tex.MAP_EMISSION: T.MATERIAL_TEXTURE_EMISSION}


def hit_groups(groups_word: int, texture_bits: int, ao: bool = T.ENABLE_AO) -> int:
    """The packed groups K7's textured_hit reads at a hit whose material has
    ``texture_bits``, from ``map_groups``' word: those of each map the
    scene and the material have (the AO map's only with ``ao``)."""
    out = 0
    for m, bit in _MAP_BITS.items():
        g = (groups_word >> (4 * m)) & 15
        if g and texture_bits & bit and (m != tex.MAP_AO or ao):
            out |= g
    return out


def _buffers(what: str, fr: Frame, st: LaneState, wv: Wave) -> WaveBuffers:
    """``wv``'s buffers, with ``fr`` and ``st`` checked and packed unless
    they are the ones last seen."""
    dev = _cuda_route(what, fr)
    b = wv.buf
    if b is None:
        raise ValueError(f"{what}: the Wave has no buffers (make it with make_wave on the kernel "
                         "route)")
    P = fr.pixel_x.shape[0]
    if b.lists.shape != (2, P) or b.lists.device != dev:
        raise ValueError(f"{what}: the Wave's buffers are for {b.lists.shape[1]} lanes on "
                         f"{b.lists.device}, not {P} on {dev}")
    if fr is not b.frame:
        _check_frame(what, fr, P, dev, rows=True)
        b.frame, b.frame_ptrs, b.maps_ptrs = fr, _frame_ptrs(fr, b.lane), _maps_ptrs(fr, b.lane)
    if st is not b.state:
        _check_state(what, st, P, dev, fr.settings.enable_gbuffer)
        b.state, b.state_ptrs = st, _lane_ptrs(st)
    return b


def shade_hit(fr: Frame, st: LaneState, hits: traverse2.TraverseOut, sidx: int, wv: Wave,
              rows: LaneRows | None = None):
    """One step of a sample (see ``shade_hit_listed_plain``): ``wv``'s
    pending shadow rays resolved, then the body between the traversals, from
    the closest-hit traversal's raw record ``hits`` of the lanes
    ``st.active`` traced; under geometry sharding the record combined over
    gp and the step's per-lane ``rows`` (``lane_rows``: K7's lane-row
    form). CPU tensors take the plain version (``hits`` made a ``Hits`` by
    ``traverse2.hits_of``); CUDA tensors launch K7's instantiation for the
    frame (``k7_variant``) over ``wv``'s list, which updates ``st`` and the
    buffers in place. Returns (state, the next ``Wave``, whose ``shadow`` is
    None in a debug view, the live-lane count as a 0-d int32 tensor)."""
    if fr.pixel_x.device.type == "cpu":
        return shade_hit_listed_plain(fr, st, traverse2.hits_of(hits, fr.tri_base), sidx, wv,
                                      rows)
    what = "shade_hit"
    b = _buffers(what, fr, st, wv)
    if bool(fr.settings.geometry_axis) != (rows is not None):
        raise ValueError(f"{what}: a gp step takes its per-lane rows (lane_rows), and only a gp "
                         "step does")
    n_rows = 0
    if rows is not None:
        lb, n_rows = b.lane, rows.shade.shape[0]
        flat = lb.flat.data_ptr()
        if not (rows.shade.data_ptr() == flat and rows.pos is not None
                and rows.pos.data_ptr() == lb.pos.data_ptr()
                and (rows.motion is not None) == lb.motion
                and (rows.motion is None or rows.motion.data_ptr() == flat + 64 * n_rows)
                and (rows.taps is None) == (lb.taps is None)
                and (rows.taps is None or rows.taps.data_ptr() == lb.taps.data_ptr())):
            raise ValueError(f"{what}: the rows are not the Wave's buffers (lane_rows with this "
                             "Wave)")
    dev = b.lists.device
    P = b.lists.shape[1]
    s = wv.steps
    if s >= b.max_steps:
        raise ValueError(f"{what}: step {s} is past the {b.max_steps} steps the Wave was made for")
    for name, dtype in (("t", torch.float32), ("tri", torch.int32), ("inst", torch.int32),
                        ("u", torch.float32), ("v", torch.float32)):
        _check(what, f"hits.{name}", getattr(hits, name), dtype, (P,), dev)
    if s > 0:
        if wv.shadow is None or wv.occluded is None:
            raise ValueError(f"{what}: step {s} needs the previous step's shadow rays traced "
                             "(Wave.occluded)")
        _check(what, "occluded", wv.occluded, torch.bool, (P,), dev)
    settings = fr.settings
    debug = settings.debug_mode != T.DEBUG_MODE_NONE
    if settings.debug_mode == T.DEBUG_MODE_MOTION and sidx > 0 and fr.had0 is None:
        raise ValueError(f"{what}: the motion view's sample {sidx} needs sample 0's had0 and "
                         "motion0 in the frame")
    variant = k7_variant(settings, fr.statics, fr.scene.atlas.band_lo is not None)
    live = b.counters[2 * (s + 1)]
    out = wv._replace(shadow=None if debug else b.shadow, occluded=None, steps=s + 1)
    if P == 0:
        return st, out, live
    from . import build

    lib = build.load()
    env = fr.scene.env_map
    atlas = fr.scene.atlas
    rc = lib.mrt_shade_hit(b.state_ptrs, b.frame_ptrs,
                           _ptrs([hits.t, hits.tri, hits.inst, hits.u, hits.v, fr.tri_base]),
                           b.shadow_ptrs, b.maps_ptrs, _ptr(wv.occluded), _ptr(b.lists),
                           _ptr(b.counters), s, P, _hbase(fr, sidx), fr.lights.shape[0],
                           env.shape[0], env.shape[1], _flags(fr, sidx), settings.max_bounces,
                           variant, map_groups(fr.statics.any_map), int(settings.debug_mode),
                           atlas.packed.shape[1], atlas.width, float(settings.width),
                           float(settings.height), _ptr(None if rows is None else rows.pos),
                           n_rows, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    launches["shade_hit"] += 1
    variant_launches[K7_VARIANTS[variant]] += 1
    return st, out, live


def resolve_shadow(st: LaneState, wv: Wave) -> LaneState:
    """The last step's shadow rays at a sample's end (see
    ``resolve_shadow_listed_plain``). CPU tensors take the plain version;
    CUDA tensors launch K8 over ``wv``'s last list (in place)."""
    dev = st.accumulated.device
    if dev.type == "cpu":
        return resolve_shadow_listed_plain(st, wv)
    what = "resolve_shadow"
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    b = wv.buf
    if b is None:
        raise ValueError(f"{what}: the Wave has no buffers (make it with make_wave on the kernel "
                         "route)")
    if wv.shadow is None:
        return st
    if wv.occluded is None:
        raise ValueError(f"{what}: the last step's shadow rays were not traced (Wave.occluded)")
    P = b.lists.shape[1]
    _check(what, "accumulated", st.accumulated, torch.float32, (P, 3), dev)
    _check(what, "occluded", wv.occluded, torch.bool, (P,), dev)
    if P == 0:
        return st
    from . import build

    lib = build.load()
    sh = wv.shadow
    rc = lib.mrt_resolve_shadow(_ptr(st.accumulated), _ptr(sh.contrib), _ptr(sh.need),
                                _ptr(wv.occluded), _ptr(b.lists), _ptr(b.counters), wv.steps, P,
                                _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    launches["resolve_shadow"] += 1
    return st


def clone_state(st: LaneState) -> LaneState:
    """A copy of ``st`` (contiguous), for running a stage twice on the same
    input (the kernels update the state in place)."""
    return LaneState(*(None if t is None else t.contiguous().clone() for t in st))


def halton(i: torch.Tensor, b: torch.Tensor, digits: int) -> torch.Tensor:
    """Halton through K6's and K7's device function (``csrc/halton.cuh``):
    the radical inverse of int32 ``i`` in int32 base ``b`` (both (N,), on
    the card) with ``digits`` digits; a test entry, held bit-equal to
    ``core.halton.halton_base`` on the CPU."""
    dev = i.device
    if dev.type != "cuda":
        raise ValueError(f"halton: unsupported device {dev}")
    n = i.shape[0]
    _check("halton", "i", i, torch.int32, (n,), dev)
    _check("halton", "b", b, torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    from . import build

    lib = build.load()
    rc = lib.mrt_halton(_ptr(i), _ptr(b), _ptr(out), n, digits, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"halton kernel launch failed: CUDA error {rc}")
    return out
