"""Radiance HDR (.hdr / RGBE) loader and procedural sky — counterpart of
``mrt_tpu/assets/hdr.py``, the same NumPy code, so both packages make the
same float32 environment maps for ``Scene.set_environment``.
"""

from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray | None:
    """Minimal Radiance RGBE decoder (flat and adaptive-RLE scanlines).
    Returns (H, W, 3) float32 linear radiance, or None on failure."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
            return None
        # the header ends at a blank line; the next line is the resolution
        pos = data.find(b"\n\n")
        if pos < 0:
            return None
        pos += 2
        eol = data.find(b"\n", pos)
        dims = data[pos:eol].split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            return None
        height, width = int(dims[1]), int(dims[3])
        pos = eol + 1

        rgbe = np.zeros((height, width, 4), np.uint8)
        buf = np.frombuffer(data, np.uint8, offset=pos)
        bp = 0
        for y in range(height):
            if width < 8 or width > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
                # flat scanline
                rgbe[y] = buf[bp : bp + width * 4].reshape(width, 4)
                bp += width * 4
                continue
            bp += 4  # the 0x0202 + length header
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[bp])
                    bp += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[bp]
                        bp += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[bp : bp + count]
                        bp += count
                        x += count
        exp = rgbe[:, :, 3].astype(np.int32)
        scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
        return (rgbe[:, :, :3].astype(np.float32) + 0.5) * scale[:, :, None]
    except Exception:
        return None


def procedural_sky(height: int = 64, width: int = 128, zenith=(0.35, 0.55, 0.95),
                   horizon=(0.85, 0.85, 0.9), ground=(0.18, 0.15, 0.12), sun_dir=(0.4, 0.6, 0.3),
                   sun_color=(60.0, 55.0, 45.0), sun_sharpness: float = 800.0) -> np.ndarray:
    """Analytic sky: a zenith/horizon gradient, the ground and a sun disc, as
    an equirect lat-long map with +Y up."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    theta = (0.5 - vv) * np.pi  # elevation: +pi/2 at the top
    phi = (uu - 0.5) * 2 * np.pi
    dy = np.sin(theta)
    dx = np.cos(theta) * np.cos(phi)
    dz = np.cos(theta) * np.sin(phi)

    zenith = np.asarray(zenith, np.float32)
    horizon = np.asarray(horizon, np.float32)
    ground = np.asarray(ground, np.float32)
    t = np.clip(dy, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * np.sqrt(t)
    img = np.where(dy[..., None] >= 0, sky, ground)

    sd = np.asarray(sun_dir, np.float64)
    sd /= np.linalg.norm(sd)
    cos = dx * sd[0] + dy * sd[1] + dz * sd[2]
    disc = np.exp(sun_sharpness * (np.clip(cos, -1, 1) - 1.0))[..., None]
    img = img + np.asarray(sun_color, np.float32) * disc
    return img.astype(np.float32)
