"""The port's spans and counters (``utils/telemetry.py``) over a small scene
on the CPU: one draw under ``torch.profiler`` records the frame's stages as
ordinary host events nested in ``mrt.draw``; with no profiler a span is the
shared no-op context; a draw's counters equal what its loop did; and
``FrameStats.report`` shows them."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mrt_tpu_torch import UPSCALER_OFF, UPSCALER_TEMPORAL, Model, Renderer, Scene
from mrt_tpu_torch.kernels import wavefront as W
from mrt_tpu_torch.utils import telemetry as tm

SIZE = 16
LEVEL1 = ("mrt.draw.setup", "mrt.trace.setup", "mrt.trace.loop", "mrt.accumulate")


def renderer(upscaler=UPSCALER_OFF) -> Renderer:
    """A plane and a sphere at 16x16, 1 spp, 2 bounces, with motion-adaptive
    sampling's thresholds low enough that an orbit earns extra samples."""
    s = Scene(SIZE, SIZE)
    s.models = [Model("plane", scale=10), Model("sphere", position=[0.9, 0.4, 0.2], scale=0.4)]
    r = Renderer(s, SIZE, SIZE, device="cpu", seed=3)
    r.upscaler_mode = upscaler
    r.render_scale = 0.5
    r.samples_per_pixel = 1
    r.max_bounces = 2
    r.motion_sampling_low_threshold_pixels = 0.0
    r.motion_sampling_high_threshold_pixels = 0.05
    return r


def mrt_events(prof):
    return [e for e in prof.events() if e.name.startswith("mrt.")]


def test_a_draw_under_the_profiler_records_its_stages_in_mrt_draw():
    r = renderer()
    r.draw()
    r.orbit(2.0, 0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.draw()
    evs = mrt_events(prof)
    assert not any(getattr(e, "is_user_annotation", False) for e in evs)
    draws = [e for e in evs if e.name == "mrt.draw"]
    assert len(draws) == 1 and draws[0].cpu_parent is None
    d0 = draws[0].time_range.start
    d1 = d0 + draws[0].time_range.elapsed_us()
    level1 = sorted((e for e in evs if e.cpu_parent is not None and e.cpu_parent.name == "mrt.draw"),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in level1]
    # trace.setup before the loop (trace_frame's, then trace_pixels') and after it
    assert names == ["mrt.draw.setup", "mrt.trace.setup", "mrt.trace.setup", "mrt.trace.loop",
                     "mrt.trace.setup", "mrt.trace.setup", "mrt.accumulate"]
    assert {n: names.count(n) for n in LEVEL1 if n != "mrt.trace.setup"} == {
        "mrt.draw.setup": 1, "mrt.trace.loop": 1, "mrt.accumulate": 1}
    end = d0
    for e in level1:  # disjoint, in order, inside mrt.draw
        assert e.time_range.start >= end
        end = e.time_range.start + e.time_range.elapsed_us()
    assert end <= d1
    loop = level1[names.index("mrt.trace.loop")]
    inner = {e.name for e in evs if e.cpu_parent is loop}
    assert {"mrt.sample_start", "mrt.closest", "mrt.shade", "mrt.any_hit", "mrt.sync.live",
            "mrt.resolve", "mrt.sample0"} <= inner
    sample0 = next(e for e in evs if e.name == "mrt.sample0")
    assert [e.name for e in evs if e.cpu_parent is sample0] == ["mrt.sync.extra"]
    # the stages' own torch ops are recorded under them
    assert any(e.name.startswith("aten::") and e.cpu_parent is not None
               and e.cpu_parent.name == "mrt.sync.live" for e in prof.events())


def test_the_present_records_its_span_and_its_kernel_wrappers():
    r = renderer(UPSCALER_TEMPORAL)
    r.draw()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.present_device()
    evs = mrt_events(prof)
    present = [e for e in evs if e.name == "mrt.present"]
    assert len(present) == 1
    assert sorted(e.name for e in evs if e.cpu_parent is present[0]) == [
        "mrt.resize", "mrt.temporal_resolve"]


def test_no_profiler_no_span():
    assert not torch._C._autograd._profiler_enabled()
    before = dict(tm.counters)
    spans = {tm.span(name) for name in ("mrt.draw", "mrt.closest", "anything")}
    assert spans == {tm._OFF}
    with tm.span("mrt.draw"):
        pass
    assert tm.counters == before
    # a span opened before a profiler starts is not recorded by it
    s = tm.span("mrt.before")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with s:
            torch.ones(2).add_(1)
        with tm.span("mrt.during"):
            pass
    assert [e.name for e in mrt_events(prof)] == ["mrt.during"]


def test_a_draws_counters_equal_what_its_loop_did(monkeypatch):
    r = renderer()
    r.draw()
    r.orbit(2.0, 0.0)
    steps = []  # the lanes each shade_hit step runs over
    shade_hit = W.shade_hit

    def counting(fr, st, hits, sidx, wv, rows=None):
        steps.append(int(st.active.sum()))
        return shade_hit(fr, st, hits, sidx, wv, rows)

    monkeypatch.setattr(W, "shade_hit", counting)
    before = dict(tm.counters)
    r.draw()
    got = {k: tm.counters.get(k, 0) - before.get(k, 0) for k in tm.counters}
    P = r.render_width * r.render_height
    assert r.settings().max_extra_samples == 2
    assert got["frames"] == 1
    assert got["loop_steps"] == len(steps) > 0
    # one live-lane read a step, and the extra levels' read
    assert got["host_syncs"] == len(steps) + 1
    assert got["live_lanes"] == sum(steps)
    assert got["lane_slots"] == len(steps) * P
    extra = int((r.last_samples - r.samples_per_pixel).sum())
    assert got["extra_samples"] == extra > 0


def test_setup_is_timed_and_the_report_shows_the_counters():
    tm.reset()
    r = renderer()
    assert tm.counters["setup.scene_compile_s"] > 0 and tm.counters["setup.bvh_build_s"] > 0
    for _ in range(2):
        r.draw()
    report = r.stats.report()
    assert {"frames", "frame_ms", "fps", "total_rays", "mrays_per_s"} <= set(report)
    assert report["frames"] == 2
    assert report["host_syncs_per_frame"] == pytest.approx(tm.counters["host_syncs"] / 2, abs=1e-3)
    assert report["loop_steps_per_frame"] == pytest.approx(tm.counters["loop_steps"] / 2, abs=1e-3)
    for key in ("live_lanes_per_frame", "lane_slots_per_frame", "scene_compile_s",
                "bvh_build_s"):
        assert key in report
    assert "frames_per_frame" not in report
    tm.reset()
    assert tm.counters == {}


def test_timed_adds_seconds_even_when_the_block_raises():
    tm.reset()
    with pytest.raises(ValueError):
        with tm.timed("setup.x_s"):
            raise ValueError
    with tm.timed("setup.x_s"):
        pass
    assert tm.counters["setup.x_s"] >= 0
    tm.count("n")
    tm.count("n", 4)
    assert tm.counters["n"] == 5
    tm.reset()
    assert tm.counters == {}
