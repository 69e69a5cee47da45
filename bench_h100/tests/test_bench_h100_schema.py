"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
each cell's configuration, traffic and per-layer readers by name alone:
a new cell, configuration or metric is new files and a new entry."""

import json
import re
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(text_ok(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    for word in b["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p.rstrip("/") + "/") for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries():
    b = bench()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["why"]) and text_ok(c["source"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in b["paths"])
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in b["workloads"]} == names
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    metric_names = list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for cell in cells:  # each cell reports setup_s, another end-to-end metric and a per-layer one
        assert sum(cell in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    import run

    files = run.cell_files(bench(), cell)
    assert files["config"]["name"] == files["cell"]["config"]
    for key in ("width", "height", "upscaler", "samples_per_pixel", "max_bounces", "orbit",
                "present", "warmup_frames", "profile_frames", "check_pixels"):
        assert key in files["traffic"]
    assert all(callable(read) for _, read in files["metrics"].values())


def test_a_new_cell_config_and_metric_are_files_and_entries(tmp_path):
    """A copy of the benchmark with a new configuration, traffic and
    per-layer reader, each a new file, and new entries: the harness finds
    them by name with no edit to a file that was there."""
    import run

    shutil.copytree(BENCH, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    (tmp_path / "bench_h100" / "configs" / "app_small.json").write_text(json.dumps(dict(
        name="app_small", include_robot=False, dragon_subdivisions=None, asset_models=False,
        motion_adaptive_sampling=False)))
    traffic = json.loads((BENCH / "traffic" / "fixed_camera_1080p.json").read_text())
    (tmp_path / "bench_h100" / "traffic" / "fixed_camera_720p.json").write_text(
        json.dumps(dict(traffic, width=1280, height=720)))
    (tmp_path / "bench_h100" / "metrics" / "k7_ms_per_frame.py").write_text(
        "def read(trace):\n    return 1.5\n")
    b["configs"].append(dict(name="app_small", source="https://example.org",
                             file="bench_h100/configs/app_small.json", reduced=[], why="x"))
    b["workloads"].append(dict(name="small_720p", config="app_small",
                               traffic="fixed_camera_720p", chips=1, why="x"))
    b["per_layer"].append(dict(name="k7_ms_per_frame", unit="ms/frame", better="lower",
                               source="device_trace", layer="wavefront stages (K6-K8)",
                               moves="mrays_per_s", workloads=["small_720p"]))
    files = run.cell_files(b, "small_720p", root=tmp_path)
    assert files["config"]["name"] == "app_small"
    assert files["traffic"]["width"] == 1280
    assert files["metrics"]["k7_ms_per_frame"][1]({}) == 1.5
    assert "k7_ms_per_frame" not in run.cell_files(b, "motion_1080p", root=tmp_path)["metrics"]
