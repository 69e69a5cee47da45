"""The measuring path refuses to run without a card, and a directory that
holds only the benchmark (no port) cannot give a result."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ARGS = ["--workload", "static_dragon1m_1080p", "--seed", "2147483659", "--seconds", "1",
        "--trace", "0"]


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch

    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("with_port", [False, True])
def test_a_run_without_a_card_prints_no_result(tmp_path, with_port):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if with_port:
        (tmp_path / "mrt_tpu_torch").symlink_to(ROOT / "mrt_tpu_torch")
    out = subprocess.run([sys.executable, "bench_h100/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
