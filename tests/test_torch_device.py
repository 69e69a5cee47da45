"""The port's entry points run on the card unless the caller asks for the
CPU: without a device they resolve to CUDA and raise where there is none.
The check runs when the entry point is called (``torch.cuda.is_available``
is monkeypatched), never when a module is imported."""

import pytest
import torch

from mrt_tpu.bvh import twolevel as jtl
from mrt_tpu.engine.scene import Model as JModel
from mrt_tpu.engine.scene import Scene as JScene
from mrt_tpu_torch import Model, Renderer, Scene, convert, demo, smoke
from mrt_tpu_torch.core.device import resolve
from mrt_tpu_torch.core.types import default_materials
from mrt_tpu_torch.upscale import denoise
from test_torch_scene_bvh import one_torch_thread  # noqa: F401


def _scene():
    s = Scene(16, 16)
    s.models = [Model("sphere", position=[0, 0.5, 0], scale=0.5), Model("plane", scale=10)]
    return s


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_renderer_without_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(_scene(), 16, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(_scene(), 16, 16, device="cuda")
    r = Renderer(_scene(), 16, 16, device="cpu")
    assert r.device == torch.device("cpu") and r.bvh.table.device.type == "cpu"


@pytest.mark.parametrize("entry", ["denoise.init_state", "default_materials", "smoke", "demo"])
def test_state_and_entry_points_without_device_raise_without_card(no_card, entry, tmp_path):
    """The denoiser's empty state, the default materials and the two user
    entry points (``python -m mrt_tpu_torch.smoke`` / ``.demo`` with
    neither --cpu nor --device) resolve to the card and raise without one;
    the first two are made on the CPU when asked."""
    make = {"denoise.init_state": lambda d: denoise.init_state(4, 5, d),
            "default_materials": lambda d: default_materials(3, d),
            "smoke": lambda d: smoke.main(["--size", "8", "--out", str(tmp_path / "s.png")]),
            "demo": lambda d: demo.main(["--size", "8", "--frames", "1", "--no-asset-models",
                                         "--out", str(tmp_path / "d.gif")])}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(None)
    assert not any(tmp_path.iterdir())
    if entry in ("denoise.init_state", "default_materials"):
        assert all(t.device.type == "cpu" for t in make("cpu"))


def test_scene_compile_and_convert_default_to_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _scene().compile()
    js = JScene(16, 16)
    js.models = [JModel("sphere", position=[0, 0.5, 0], scale=0.5), JModel("plane", scale=10)]
    jd, jst = js.compile()
    jb = jtl.build(js.models, jd, jst.skin_slices, host_mirror=js.host_mirror)
    for call in (lambda: convert.scene_data(jd), lambda: convert.bvh(jb),
                 lambda: convert.compiled(jd, jst, jb)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pd, _, pb = convert.compiled(jd, jst, jb, device="cpu")
    assert pd.positions_obj.device.type == "cpu" and pb.table.device.type == "cpu"


@pytest.mark.parametrize("available", [False, True])
def test_resolve(monkeypatch, available):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    if available:
        assert resolve(None) == torch.device("cuda")
        assert resolve("cuda:0") == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError):
            resolve(None)
