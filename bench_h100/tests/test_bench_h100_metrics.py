"""The metric arithmetic: end-to-end numbers over the whole window, the
per-layer readers over a made-up profile, and the frozen bounds at the
cells' shapes."""

import math

import pytest


def test_window_rate_is_all_rays_over_all_time_and_p95_covers_every_frame():
    import run

    # 99 frames of 10 ms and one stall of 200 ms among them
    intervals = [10.0] * 50 + [200.0] + [10.0] * 49
    stamps, t = [], 0.0
    for d in intervals:
        t += d
        stamps.append(t)
    rays = 100 * 1_000_000
    m = run.window_metrics(stamps, rays)
    assert m["window_s"] == pytest.approx(1.19)
    assert m["mrays_per_s"] == pytest.approx(100 / 1.19)  # not the median frame's 100 Mrays/10 ms
    assert m["fps"] == pytest.approx(100 / 1.19)
    assert m["frames"] == 100
    # the 95th percentile of 100 intervals with one stall stays at 10 ms; with
    # six stalls it is the stall
    assert m["frame_ms_p95"] == pytest.approx(10.0)
    six = [10.0] * 94 + [200.0] * 6
    stamps6 = [sum(six[:i + 1]) for i in range(len(six))]
    assert run.window_metrics(stamps6, rays)["frame_ms_p95"] == pytest.approx(200.0)


def trace(events, frames=2, frame_wall_s=0.010, present=True):
    return dict(events=events, host=[], frames=frames, frame_wall_s=frame_wall_s, wall_s=0.03,
                counters={}, traffic=dict(width=3840, height=2160, upscaler="temporal",
                                          render_scale=0.5, present=present))


EVENTS = [  # (name, start us, duration us) over two frames
    ("void traverse2_kernel<false, false, false>(...)", 0.0, 3000.0),
    ("traverse2_compact_kernel", 3000.0, 100.0),
    ("void shade_hit_kernel(...)", 3200.0, 500.0),
    ("sample_start_kernel", 3700.0, 100.0),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n", 3800.0, 50.0),
    ("void refit_rows_kernel<true>(...)", 3850.0, 10.0),
    ("resize_strip_kernel<2, 3, 1, 2>", 4000.0, 100.0),
    ("temporal_resolve_u8_kernel", 4100.0, 271.0),
    ("Memset (Device)", 4371.0, 29.0),
    ("void traverse2_kernel<false, false, false>(...)", 10000.0, 3000.0),
    ("resize_strip_kernel<2, 3, 1, 2>", 13000.0, 100.0),
    ("temporal_resolve_u8_kernel", 13100.0, 271.0),
]


@pytest.mark.parametrize("name, expected", [
    ("device_events_per_frame", 6.0),
    ("traversal_ms_per_frame", 3.05),
    ("shade_ms_per_frame", 0.3),
    ("present_ms_per_frame", 0.371),
    ("present_roofline", 100 * 0.10151355223880597 / 0.371),
    ("idle_share", 1 - 0.0037655 / 0.010),
])
def test_readers(name, expected):
    import run

    read = run.load_reader(run.HERE / "metrics" / f"{name}.py")
    assert read(trace(EVENTS)) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["traversal_ms_per_frame", "present_ms_per_frame", "present_roofline", "idle_share",
                                  "device_events_per_frame", "shade_ms_per_frame"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    import run

    read = run.load_reader(run.HERE / "metrics" / f"{name}.py")
    assert read(trace([], present=False)) is None


def test_busy_is_the_union_of_device_spans_and_breakdown_names_the_host():
    import run
    import tracelib

    ev = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0), ("a", 50.0, 5.0)]
    assert tracelib.busy_seconds(ev) == pytest.approx(25e-6)
    tr = dict(events=ev, host=[("aten::item", 16.0, 12.0), ("cudaLaunchKernel", 36.0, 2.0)])
    b = run.breakdown(tr)
    assert b["device_ops"][0] == ["a", pytest.approx(15e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(15e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(15e-6)


@pytest.mark.parametrize("mode, expected", [("temporal", 0.1015), ("spatial", None),
                                            ("denoised", None)])
def test_frozen_present_bounds_give_perf_md_figures(mode, expected):
    import bounds

    got = bounds.present(mode, 1080, 1920, 2160, 3840)
    assert (got if expected is None else round(got[0], 4)) == expected


@pytest.mark.parametrize("shape", [(1080, 1920, 2160, 3840), (686, 686, 1024, 1024),
                                   (1080, 1920, 1080, 1920)])
def test_frozen_bounds_equal_the_ports_at_freezing(shape):
    import bounds
    from mrt_tpu_torch.utils import bounds as port

    assert bounds.present("temporal", *shape) == port.present("temporal", *shape)
    assert math.isclose(bounds.PEAK_BYTES, 3.35e12) and math.isclose(bounds.PEAK_F32_OPS, 33.5e12)


def test_steady_host_pins_the_window_to_one_cpu_and_undoes_it():
    import gc
    import os

    import run

    cpus = os.sched_getaffinity(0)
    undo, rates = run.steady_host(spin_s=0.002, trials=1)
    try:
        assert set(rates) == cpus
        assert os.sched_getaffinity(0) == {max(rates, key=rates.get)}
        assert not gc.isenabled()
    finally:
        undo()
    assert os.sched_getaffinity(0) == cpus and gc.isenabled()
