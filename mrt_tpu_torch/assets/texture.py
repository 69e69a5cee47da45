"""Texture atlas — counterpart of ``mrt_tpu/assets/texture.py``.

The host side (shelf packing of every map of every resource, the mip chain
placement, the channel-packed twin) is the JAX package's NumPy code, so the
atlas layout is identical. The device side is the bilinear sampling of the
channel-packed atlas (``sample_packed``), of a per-map rect
(``sample_bilinear``) and, with ``RenderSettings.use_mipmaps``, the
trilinear sampling of each map's mip chain at a ray-cone LOD
(``sample_trilinear``), as torch gathers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

MAP_BASECOLOR = 0
MAP_NORMAL = 1
MAP_ROUGHNESS = 2
MAP_METALLIC = 3
MAP_AO = 4
MAP_OPACITY = 5
MAP_EMISSION = 6
N_MAP_TYPES = 7

_SRGB_MAPS = {MAP_BASECOLOR, MAP_EMISSION}
_FALLBACKS = {
    MAP_BASECOLOR: (1.0, 1.0, 1.0),
    MAP_NORMAL: (0.5, 0.5, 1.0),
    MAP_ROUGHNESS: (1.0, 1.0, 1.0),
    MAP_METALLIC: (0.0, 0.0, 0.0),
    MAP_AO: (1.0, 1.0, 1.0),
    MAP_OPACITY: (1.0, 1.0, 1.0),
    MAP_EMISSION: (0.0, 0.0, 0.0),
}

MAX_MIPS = 12

# channel-packed layout: all maps of a resource at one rect, as channels of a
# 16-wide texel
PACKED_C = 16
_PACKED_SLICE = {  # map type -> (start, width) in the packed texel
    MAP_BASECOLOR: (0, 3),
    MAP_NORMAL: (3, 3),
    MAP_EMISSION: (6, 3),
    MAP_ROUGHNESS: (9, 1),
    MAP_METALLIC: (10, 1),
    MAP_AO: (11, 1),
    MAP_OPACITY: (12, 1),
}


class TextureAtlas(NamedTuple):
    """Atlas tensors: every map's mip chain in ``texels``, its level rects in
    ``mip_rects``, and the channel-packed level-0 twin."""

    texels: torch.Tensor  # (H, W, 3) f32 linear
    rects: torch.Tensor  # (R, N_MAP_TYPES, 4) int32: x0, y0, w, h (level 0)
    has_map: torch.Tensor  # (R, N_MAP_TYPES) bool
    # level-l rect per (resource, map); levels past a chain's end repeat its last
    mip_rects: torch.Tensor  # (R, N_MAP_TYPES, MAX_MIPS, 4) int32
    n_levels: torch.Tensor  # (R, N_MAP_TYPES) int32 >= 1
    packed: torch.Tensor  # (Hp, Wp, PACKED_C) f32
    packed_rects: torch.Tensor  # (R, 4) int32 x0, y0, w, h

    @property
    def height(self) -> int:
        return self.texels.shape[0]

    @property
    def width(self) -> int:
        return self.texels.shape[1]


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def load_image(path: str) -> np.ndarray | None:
    """Load an image file to (H, W, 3) float32 in [0, 1]; None on failure
    (texture-load fallback posture, SubMesh.swift:104,176-241)."""
    try:
        from PIL import Image

        img = Image.open(path).convert("RGB")
        return np.asarray(img, np.float32) / 255.0
    except Exception:
        return None


@dataclasses.dataclass
class AtlasBuilder:
    """Shelf-packs images; duplicates (same path) share one rect."""

    max_width: int = 4096

    def __post_init__(self):
        self._images: list = []  # (array, x0, y0)
        self._by_path: dict = {}
        self._shelf_x = 0
        self._shelf_y = 0
        self._shelf_h = 0
        self._height = 0
        self._width = 0
        self._resources: list = []  # per resource: {map_type: (rect, has)}

    def _place(self, img: np.ndarray) -> tuple[int, int]:
        h, w = img.shape[:2]
        if self._shelf_x + w > self.max_width:
            self._shelf_y += self._shelf_h
            self._shelf_x = 0
            self._shelf_h = 0
        x0, y0 = self._shelf_x, self._shelf_y
        self._shelf_x += w
        self._shelf_h = max(self._shelf_h, h)
        self._height = max(self._height, y0 + h)
        self._width = max(self._width, x0 + w)
        self._images.append((img, x0, y0))
        return x0, y0

    @staticmethod
    def _downsample(img: np.ndarray) -> np.ndarray:
        """2x2 box filter (the mipmap generation the reference gets from
        generateMipmaps, SubMesh.swift:189-206). Odd dims replicate the edge."""
        h, w = img.shape[:2]
        if h % 2:
            img = np.concatenate([img, img[-1:]], axis=0)
            h += 1
        if w % 2:
            img = np.concatenate([img, img[:, -1:]], axis=1)
            w += 1
        return img.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3)).astype(np.float32)

    def add_resource(self, maps: dict[int, str | np.ndarray | None]) -> int:
        """Register one resource (submesh). ``maps`` maps MAP_* -> path/array/None.
        Returns the resource index."""
        entry = {}
        for map_type in range(N_MAP_TYPES):
            src = maps.get(map_type)
            img = None
            if isinstance(src, str):
                # dedup key includes colorspace: the same file used as an
                # sRGB map (baseColor/emission) and as a linear map packs
                # DIFFERENT texels, so they must not share a rect
                pkey = (src, map_type in _SRGB_MAPS)
                if pkey in self._by_path:
                    entry[map_type] = (self._by_path[pkey], True)
                    continue
                img = load_image(src)
            elif isinstance(src, np.ndarray):
                img = src.astype(np.float32)
                if img.ndim == 2:
                    img = np.repeat(img[:, :, None], 3, axis=2)
            if img is None:
                entry[map_type] = ([(0, 0, 1, 1)], False)
                continue
            if map_type in _SRGB_MAPS:
                img = srgb_to_linear(img)
            # place the full mip chain; level 0 first
            chain = []
            level = img
            while len(chain) < MAX_MIPS:
                x0, y0 = self._place(level)
                chain.append((x0, y0, level.shape[1], level.shape[0]))
                if max(level.shape[0], level.shape[1]) <= 1:
                    break
                level = self._downsample(level)
            if isinstance(src, str):
                self._by_path[(src, map_type in _SRGB_MAPS)] = chain
            entry[map_type] = (chain, True)
        self._resources.append(entry)
        return len(self._resources) - 1

    def build(self) -> TextureAtlas:
        n_res = max(len(self._resources), 1)
        # Fallback 1x1 tiles live at a reserved row appended below the shelves.
        fb_y = self._height
        fb_rects = {}
        for map_type in range(N_MAP_TYPES):
            fb_rects[map_type] = (map_type, fb_y, 1, 1)
        height = self._height + 1
        width = max(self._width, N_MAP_TYPES, 1)

        texels = np.zeros((height, width, 3), np.float32)
        for img, x0, y0 in self._images:
            texels[y0 : y0 + img.shape[0], x0 : x0 + img.shape[1], :] = img[:, :, :3]
        for map_type, (x0, y0, _, _) in fb_rects.items():
            texels[y0, x0, :] = _FALLBACKS[map_type]

        rects = np.zeros((n_res, N_MAP_TYPES, 4), np.int32)
        has = np.zeros((n_res, N_MAP_TYPES), bool)
        mip_rects = np.zeros((n_res, N_MAP_TYPES, MAX_MIPS, 4), np.int32)
        n_levels = np.ones((n_res, N_MAP_TYPES), np.int32)
        for r in range(n_res):
            entry = self._resources[r] if r < len(self._resources) else {}
            for map_type in range(N_MAP_TYPES):
                chain, present = entry.get(map_type, ([(0, 0, 1, 1)], False))
                if not present:
                    chain = [fb_rects[map_type]]
                rects[r, map_type] = chain[0]
                has[r, map_type] = present
                n_levels[r, map_type] = len(chain)
                for li in range(MAX_MIPS):
                    mip_rects[r, map_type, li] = chain[min(li, len(chain) - 1)]
        packed, packed_rects = self._build_packed(texels, rects, has)
        # host mirror of has_map for the scene compiler
        self.has_np = has
        return TextureAtlas(
            texels=torch.as_tensor(texels), rects=torch.as_tensor(rects),
            has_map=torch.as_tensor(has), mip_rects=torch.as_tensor(mip_rects),
            n_levels=torch.as_tensor(n_levels), packed=torch.as_tensor(packed),
            packed_rects=torch.as_tensor(packed_rects),
        )

    @staticmethod
    def _build_packed(texels, rects, has):
        """Channel-packed twin: per resource, one rect at its largest map's
        size with every map resampled into PACKED_C channels."""
        n_res = rects.shape[0]
        sizes = []
        for r in range(n_res):
            w = h = 1
            for mt in range(N_MAP_TYPES):
                if has[r, mt]:
                    w = max(w, int(rects[r, mt, 2]))
                    h = max(h, int(rects[r, mt, 3]))
            sizes.append((w, h))

        # shelf-pack the per-resource tiles
        max_w = max(4096, max(w for w, _ in sizes))
        sx = sy = sh = 0
        out_rects = np.zeros((n_res, 4), np.int32)
        for r, (w, h) in enumerate(sizes):
            if sx + w > max_w:
                sy += sh
                sx = 0
                sh = 0
            out_rects[r] = (sx, sy, w, h)
            sx += w
            sh = max(sh, h)
        Hp, Wp = sy + sh if n_res else 1, max(max(x + w for (x, _, w, _) in
                                                 [tuple(rr) for rr in out_rects]), 1)
        packed = np.zeros((max(Hp, 1), Wp, PACKED_C), np.float32)
        for r, (w, h) in enumerate(sizes):
            x0, y0 = int(out_rects[r, 0]), int(out_rects[r, 1])
            for mt in range(N_MAP_TYPES):
                c0, cw = _PACKED_SLICE[mt]
                if has[r, mt]:
                    rx, ry, rw, rh = (int(v) for v in rects[r, mt])
                    src = texels[ry : ry + rh, rx : rx + rw, :]
                    img = src if (rw == w and rh == h) else _resize_bilinear(src, h, w)
                else:
                    img = np.broadcast_to(
                        np.asarray(_FALLBACKS[mt], np.float32), (h, w, 3))
                packed[y0 : y0 + h, x0 : x0 + w, c0 : c0 + cw] = img[:, :, :cw]
        return packed, out_rects


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pack-time numpy bilinear resize (half-pixel centers, edge clamp)."""
    sh, sw = img.shape[:2]
    ys = (np.arange(h, dtype=np.float32) + 0.5) * sh / h - 0.5
    xs = (np.arange(w, dtype=np.float32) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, sh - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def _packed_taps(packed_rects: torch.Tensor, resource: torch.Tensor, uv: torch.Tensor):
    """The 4 global tap coordinates (repeat addressing inside the resource's
    rect) and the (R, 1) bilinear weights."""
    rect = packed_rects[resource.long()]
    x0 = rect[:, 0].to(torch.float32)
    y0 = rect[:, 1].to(torch.float32)
    w = rect[:, 2].to(torch.float32)
    h = rect[:, 3].to(torch.float32)

    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * w - 0.5
    y = v * h - 0.5
    xf = torch.floor(x)
    yf = torch.floor(y)
    fx = (x - xf)[:, None]
    fy = (y - yf)[:, None]

    gx0 = (x0 + torch.remainder(xf, w)).to(torch.int32)
    gx1 = (x0 + torch.remainder(xf + 1.0, w)).to(torch.int32)
    gy0 = (y0 + torch.remainder(yf, h)).to(torch.int32)
    gy1 = (y0 + torch.remainder(yf + 1.0, h)).to(torch.int32)
    return gx0, gx1, gy0, gy1, fx, fy


def sample_packed(atlas: TextureAtlas, resource: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """One bilinear sample of the channel-packed atlas: every map of the
    hit's resource as (R, PACKED_C)."""
    gx0, gx1, gy0, gy1, fx, fy = _packed_taps(atlas.packed_rects, resource, uv)
    width = atlas.packed.shape[1]
    flat = atlas.packed.reshape(-1, PACKED_C)

    def fetch(gx, gy):
        return flat[(gy * width + gx).long()]

    c00 = fetch(gx0, gy0)
    c10 = fetch(gx1, gy0)
    c01 = fetch(gx0, gy1)
    c11 = fetch(gx1, gy1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def packed_map(sampled: torch.Tensor, map_type: int) -> torch.Tensor:
    """(R, PACKED_C) packed sample -> this map's (R, 3) value."""
    c0, cw = _PACKED_SLICE[map_type]
    if cw == 3:
        return sampled[:, c0 : c0 + 3]
    c = sampled[:, c0]
    return torch.stack([c, c, c], dim=-1)


def sample_bilinear(atlas: TextureAtlas, resource: torch.Tensor, map_type: int,
                    uv: torch.Tensor) -> torch.Tensor:
    """Bilinear LOD-0 sample of one map with repeat addressing inside each
    resource's rect. resource: (R,) int; uv: (R, 2). Returns (R, 3)."""
    return _bilinear_rect(atlas, atlas.rects[resource.long(), map_type], uv)


def sample_trilinear(atlas: TextureAtlas, resource: torch.Tensor, map_type: int,
                     uv: torch.Tensor, lod_base: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of one map's mip chain. ``lod_base`` (R,) is log2 of
    the ray-cone footprint in UV units; the map's LOD adds log2 of its
    level-0 texel size, so one footprint drives every map of a hit."""
    f32 = torch.float32
    res = resource.long()
    r0 = atlas.rects[res, map_type]
    nl = atlas.n_levels[res, map_type].to(f32)
    size0 = torch.clamp(r0[:, 2].to(f32) * r0[:, 3].to(f32), min=1.0)
    lod = torch.minimum(torch.clamp(lod_base + 0.5 * torch.log2(size0), min=0.0), nl - 1.0)
    l0 = torch.floor(lod)
    l1 = torch.minimum(l0 + 1.0, nl - 1.0)
    frac = (lod - l0)[:, None]
    flat_mr = atlas.mip_rects.reshape(-1, 4)
    base = (res * N_MAP_TYPES + map_type) * MAX_MIPS
    rect0 = flat_mr[base + l0.long()]
    rect1 = flat_mr[base + l1.long()]
    c0 = _bilinear_rect(atlas, rect0, uv)
    c1 = _bilinear_rect(atlas, rect1, uv)
    return c0 * (1.0 - frac) + c1 * frac


def _bilinear_rect(atlas: TextureAtlas, rect: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with repeat addressing inside a per-lane rect (R,4)."""
    x0 = rect[:, 0].to(torch.float32)
    y0 = rect[:, 1].to(torch.float32)
    w = rect[:, 2].to(torch.float32)
    h = rect[:, 3].to(torch.float32)
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * w - 0.5
    y = v * h - 0.5
    xf = torch.floor(x)
    yf = torch.floor(y)
    fx = (x - xf)[:, None]
    fy = (y - yf)[:, None]
    xi0 = torch.remainder(xf, w)
    xi1 = torch.remainder(xf + 1.0, w)
    yi0 = torch.remainder(yf, h)
    yi1 = torch.remainder(yf + 1.0, h)
    width = atlas.width
    flat = atlas.texels.reshape(-1, 3)

    def fetch(xi, yi):
        gx = (x0 + xi).to(torch.int32)
        gy = (y0 + yi).to(torch.int32)
        return flat[(gy * width + gx).long()]

    c00 = fetch(xi0, yi0)
    c10 = fetch(xi1, yi0)
    c01 = fetch(xi0, yi1)
    c11 = fetch(xi1, yi1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy
