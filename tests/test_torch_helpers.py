"""The public helpers that no path of either package calls, against the JAX
package's functions on seeded NumPy inputs, one case each:
``core/types.default_materials``, ``utils/math3d.pack_3x4``,
``render/shade.take_rows_onehot`` (a table of at most ``max_rows`` rows,
which JAX selects by a one-hot product, and a larger one, which it
gathers), ``reinhard_tonemap`` — bit-equal; ``interpolate_attribute`` and
``compute_tangent_basis`` — ``valid`` equal, values within 1e-6 of each
row's largest component (XLA:CPU contracts multiply-adds into FMAs,
ROADMAP Q3-P1); ``utils/native.available`` and ``parse_obj_geometry`` —
bit-equal on a seeded OBJ text, None from both on a malformed one (the JAX
side's native library loaded as ``test_torch_scene_bvh.jax_sah`` makes
sure of it).

And the presenter's PNG writer without PIL (its import made to fail):
the file decodes to the same array.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mrt_tpu.core import types as JT
from mrt_tpu.render import shade as jshade
from mrt_tpu.utils import math3d as jmath3d
from mrt_tpu.utils import native as jnative
from mrt_tpu_torch.core import types as T
from mrt_tpu_torch.render import shade
from mrt_tpu_torch.upscale import presenter
from mrt_tpu_torch.utils import math3d, native
from test_torch_scene_bvh import _bits_equal, jax_sah, one_torch_thread  # noqa: F401

RNG_SEED = 11


def _rows_close(p, j, tol=1e-6):
    """|p - j| within ``tol`` of each row's largest |j| component."""
    p, j = np.asarray(p, np.float64), np.asarray(j, np.float64)
    scale = np.maximum(np.abs(j).max(axis=-1, keepdims=True), 1e-30)
    return float((np.abs(p - j) / scale).max())


def _mesh(rng, n_vert=40, n_tri=60, n_rays=500):
    indices = rng.integers(0, n_vert, (n_tri, 3)).astype(np.int32)
    tri = rng.integers(-1, n_tri, n_rays).astype(np.int32)
    u = rng.random(n_rays, dtype=np.float32)
    v = (rng.random(n_rays, dtype=np.float32) * (1 - u)).astype(np.float32)
    return indices, tri, u, v


def _obj_text(rng, bad: bool) -> str:
    """Vertices, uvs and normals, then faces in the v, v/vt, v//vn and
    v/vt/vn forms, triangles and quads; ``bad``: one face refers to a
    vertex past the end."""
    nv, nt, nn = 24, 17, 9
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in rng.standard_normal((nv, 3))]
    lines += [f"vt {s:.6f} {t:.6f}" for s, t in rng.random((nt, 2))]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in rng.standard_normal((nn, 3))]
    for f in range(40):
        k = 3 + int(rng.integers(0, 2))
        vs = rng.integers(1, nv + 1, k)
        form = f % 4
        corners = [str(a) if form == 0 else
                   f"{a}/{rng.integers(1, nt + 1)}" if form == 1 else
                   f"{a}//{rng.integers(1, nn + 1)}" if form == 2 else
                   f"{a}/{rng.integers(1, nt + 1)}/{rng.integers(1, nn + 1)}" for a in vs]
        lines.append("f " + " ".join(corners))
    if bad:
        lines.append(f"f 1 2 {nv + 50}")
    return "\n".join(lines) + "\n"


def _check(name, rng, tmp_path):
    if name == "default_materials":
        j, p = JT.default_materials(7), T.default_materials(7, "cpu")
        for field in JT.Materials._fields:
            assert _bits_equal(getattr(j, field), getattr(p, field).numpy()), field
    elif name == "pack_3x4":
        m = rng.standard_normal((4, 4)).astype(np.float32)
        want = jmath3d.pack_3x4(m)
        assert _bits_equal(want, math3d.pack_3x4(m))
        packed = math3d.pack_3x4(torch.from_numpy(m))
        assert packed.is_contiguous() and _bits_equal(want, packed.numpy())
    elif name.startswith("take_rows_onehot"):
        n_rows = 13 if name.endswith("small") else 300  # each side of max_rows=128
        table = rng.standard_normal((n_rows, 20)).astype(np.float32)
        idx = rng.integers(0, n_rows, 1000).astype(np.int32)
        j = jshade.take_rows_onehot(jnp.asarray(table), jnp.asarray(idx))
        p = shade.take_rows_onehot(torch.from_numpy(table), torch.from_numpy(idx))
        assert _bits_equal(j, p.numpy())
    elif name == "reinhard_tonemap":
        c = (rng.random((64, 48, 3), dtype=np.float32) * 8.0).astype(np.float32)
        j = jshade.reinhard_tonemap(jnp.asarray(c))
        assert _bits_equal(j, shade.reinhard_tonemap(torch.from_numpy(c)).numpy())
    elif name == "interpolate_attribute":
        indices, tri, u, v = _mesh(rng)
        attr = rng.standard_normal((40, 5)).astype(np.float32)
        j = jshade.interpolate_attribute(*(jnp.asarray(x) for x in (attr, indices, tri, u, v)))
        p = shade.interpolate_attribute(*(torch.from_numpy(x) for x in (attr, indices, tri, u, v)))
        assert p.shape == j.shape and _rows_close(p.numpy(), j) <= 1e-6
    elif name == "compute_tangent_basis":
        indices, tri, _, _ = _mesh(rng)
        pos = rng.standard_normal((40, 3)).astype(np.float32)
        uvs = rng.random((40, 2), dtype=np.float32)
        uvs[:4] = uvs[4]  # some triangles with a degenerate uv map
        indices[:6] = [0, 1, 2]
        jv, jt, jb = jshade.compute_tangent_basis(*(jnp.asarray(x) for x in (pos, uvs, indices, tri)))
        pv, pt, pb = shade.compute_tangent_basis(*(torch.from_numpy(x)
                                                    for x in (pos, uvs, indices, tri)))
        assert np.array_equal(np.asarray(jv), pv.numpy()) and 0 < int(pv.sum()) < pv.numel()
        assert _rows_close(pt.numpy(), jt) <= 1e-6 and _rows_close(pb.numpy(), jb) <= 1e-6
    elif name == "parse_obj_geometry":
        with jax_sah():
            assert jnative.available()
            assert native.available()
            for bad in (False, True):
                path = tmp_path / f"mesh_{bad}.obj"
                path.write_text(_obj_text(rng, bad))
                j, p = jnative.parse_obj_geometry(str(path)), native.parse_obj_geometry(str(path))
                if bad:
                    assert j is None and p is None
                    continue
                assert len(p) == 4 and p[0].shape[0] > 0 and np.isnan(p[2]).any()
                for a, b in zip(j, p):
                    assert a.dtype == b.dtype and _bits_equal(a, b)
    else:
        raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "default_materials", "pack_3x4", "take_rows_onehot_small", "take_rows_onehot_large",
    "reinhard_tonemap", "interpolate_attribute", "compute_tangent_basis", "parse_obj_geometry"])
def test_helper_matches_jax(name, tmp_path):
    _check(name, np.random.default_rng(RNG_SEED), tmp_path)


def test_presenter_png_without_pil(tmp_path, monkeypatch):
    img = np.random.default_rng(RNG_SEED).integers(0, 256, (19, 23, 3), dtype=np.uint8)
    path = tmp_path / "frame.png"
    with monkeypatch.context() as mp:
        for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
            mp.setitem(sys.modules, mod, None)  # any import of PIL now fails
        with pytest.raises(ImportError):
            import PIL.Image  # noqa: F401
        presenter.write_png(str(path), img)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), img)
