"""The device's idle share of a frame: 1 - busy / wall, the busy seconds a
profiled frame (the union of its device events) against the unprofiled
window's mean frame wall (the profiler slows the host, not the kernels)."""

from tracelib import busy_seconds


def read(trace: dict) -> float | None:
    if not trace["events"]:
        return None
    return 1.0 - busy_seconds(trace["events"]) / trace["frames"] / trace["frame_wall_s"]
