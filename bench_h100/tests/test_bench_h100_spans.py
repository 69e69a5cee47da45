"""The readers of the port's spans and counters (``spanlib``): a made-up
profile with gaps inside and outside the spans is split by stage and scaled
to the unprofiled idle a frame; a program without the spans or the
counters reads as nothing."""

import sys

import pytest

# two frames of 10 ms unprofiled; device events (name, start µs, duration µs):
# busy 4,000 µs (2 ms a frame), four gaps of 500, 500, 500 and 1,000 µs
EVENTS = [("k", 0.0, 1000.0), ("k", 1500.0, 1000.0), ("k", 3000.0, 500.0),
          ("k", 4000.0, 1000.0), ("k", 6000.0, 500.0)]
HOST = [
    ("mrt.draw", 0.0, 3600.0),  # gaps 1, 2 whole and 100 µs of gap 3
    ("mrt.trace.loop", 1200.0, 1600.0),  # 300 µs of gap 1, 300 of gap 2
    ("mrt.sync.live", 1400.0, 200.0),  # 100 µs of gap 1
    ("aten::item", 1000.0, 600.0),  # not a span of the program's
    ("mrt.present", 3700.0, 300.0),  # 300 µs of gap 3
]
IDLE_MS = 10.0 - 2.0  # the unprofiled idle a frame
PROFILED_IDLE_US = 2500.0


def trace(host=HOST, events=EVENTS):
    return dict(events=events, host=host, frames=2, frame_wall_s=0.010, wall_s=0.03,
                counters={}, traffic={}, config={}, cell={})


def reader(name):
    import run

    return run.load_reader(run.HERE / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name, part_us", [("loop_idle_ms_per_frame", 600.0),
                                           ("frame_setup_idle_ms_per_frame", 500.0),
                                           ("present_idle_ms_per_frame", 300.0)])
def test_idle_readers_split_and_scale_the_idle(name, part_us):
    assert reader(name)(trace()) == pytest.approx(part_us / PROFILED_IDLE_US * IDLE_MS)


def test_the_stages_and_the_rest_add_up_to_idle_share_times_the_frame_wall():
    import spanlib

    t = trace()
    parts = sum(reader(n)(t) for n in ("loop_idle_ms_per_frame", "frame_setup_idle_ms_per_frame",
                                       "present_idle_ms_per_frame"))
    rest = 1100.0 / PROFILED_IDLE_US * IDLE_MS  # gap 4 and 100 µs of gap 3
    idle_share = reader("idle_share")(t)
    assert parts + rest == pytest.approx(idle_share * 10.0)
    assert spanlib.idle_gaps(EVENTS) == [(1000.0, 1500.0), (2500.0, 3000.0), (3500.0, 4000.0),
                                         (5000.0, 6000.0)]


def test_idle_by_the_innermost_span():
    import spanlib

    got = spanlib.idle_by_span(trace())
    assert got == pytest.approx({"mrt.draw": 500.0, "mrt.trace.loop": 500.0,
                                 "mrt.sync.live": 100.0, "mrt.present": 300.0,
                                 "(no span)": 1100.0})
    assert spanlib.innermost(trace())[:3] == [(0.0, 1200.0, "mrt.draw"),
                                              (1200.0, 1400.0, "mrt.trace.loop"),
                                              (1400.0, 1600.0, "mrt.sync.live")]


@pytest.mark.parametrize("name", ["loop_idle_ms_per_frame", "frame_setup_idle_ms_per_frame",
                                  "present_idle_ms_per_frame"])
def test_idle_readers_without_the_spans_return_nothing(name):
    no_spans = [h for h in HOST if not h[0].startswith("mrt.")]
    assert reader(name)(trace(host=no_spans)) is None
    assert reader(name)(trace(events=[])) is None


def test_frame_setup_needs_the_loop_spans_too():
    draw_only = [h for h in HOST if h[0] != "mrt.trace.loop"]
    assert reader("frame_setup_idle_ms_per_frame")(trace(host=draw_only)) is None
    assert reader("loop_idle_ms_per_frame")(trace(host=draw_only)) is None


COUNTERS = {"frames": 40, "host_syncs": 1000, "loop_steps": 960, "live_lanes": 3_000_000,
            "lane_slots": 12_000_000, "extra_samples": 5, "setup.bvh_build_s": 4.25,
            "setup.scene_compile_s": 0.5}


@pytest.mark.parametrize("name, expected", [("host_syncs_per_frame", 25.0),
                                            ("live_lane_share", 0.25),
                                            ("bvh_build_s", 4.25)])
def test_counter_readers(monkeypatch, name, expected):
    from mrt_tpu_torch.utils import telemetry

    monkeypatch.setattr(telemetry, "counters", dict(COUNTERS))
    assert reader(name)(trace()) == pytest.approx(expected)
    monkeypatch.setattr(telemetry, "counters", {})
    assert reader(name)(trace()) is None


@pytest.mark.parametrize("name", ["host_syncs_per_frame", "live_lane_share", "bvh_build_s"])
def test_counter_readers_without_the_ports_counters_return_nothing(monkeypatch, name):
    import mrt_tpu_torch.utils
    from mrt_tpu_torch.utils import telemetry

    monkeypatch.setattr(telemetry, "counters", dict(COUNTERS))
    # a program without the telemetry module: its import fails
    monkeypatch.delattr(mrt_tpu_torch.utils, "telemetry")
    monkeypatch.setitem(sys.modules, "mrt_tpu_torch.utils.telemetry", None)
    with pytest.raises(ImportError):
        from mrt_tpu_torch.utils import telemetry  # noqa: F401, F811
    assert reader(name)(trace()) is None
