"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: each import's top-level name (the
part before the first dot) is compared whole, since ``mrt_tpu_torch``
begins with ``mrt_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mrt_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "mrt_tpu_torch" not in top_level_imports(path)


def test_whole_word_compare():
    import run

    before = dict(sys.modules)
    try:
        sys.modules["mrt_tpu_torch_x"] = object()
        sys.modules["mrt_tpu_torch.y"] = object()
        assert run.forbidden_loaded() == [n for n in run.forbidden_loaded()
                                          if n.split(".")[0] in FORBIDDEN]
        assert "mrt_tpu_torch.y" not in run.forbidden_loaded()
        sys.modules["mrt_tpu.engine"] = object()
        assert "mrt_tpu.engine" in run.forbidden_loaded()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_reference_runs_without_the_port():
    """The reference frame of a tiny cell in a process that cannot import
    the port or JAX: it loads neither."""
    code = f"""
import sys
sys.path.insert(0, {str(BENCH)!r})
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "mrt_tpu", "mrt_tpu_torch"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import torch
from reference import frame
cfg = dict(include_robot=True, dragon_subdivisions=None, asset_models=False,
           motion_adaptive_sampling=True)
tr = dict(width=24, height=16, upscaler="temporal", render_scale=1.0, samples_per_pixel=1,
          max_bounces=2, orbit=[0.02, 0], delta_time=1 / 60, present=True)
h, w = 16, 24
prog = frame.Program(torch.zeros(h, w, 3), torch.zeros(h, w, 2), torch.rand(h, w, 3),
                     torch.rand(h, w), torch.zeros(h, w, 2), None, 0, None)
ref = frame.Reference(cfg, tr, 0.5, torch.zeros(h, w, dtype=torch.int32), torch.device("cpu"))
e = frame.expected_frame(ref, 2, torch.arange(0, h * w, 7), prog)
assert tuple(e.image.shape) == (16, 24, 3)
assert len(ref.prefix(2, torch.arange(0, h * w, 11))) == 2
print(sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "mrt_tpu", "mrt_tpu_torch")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
