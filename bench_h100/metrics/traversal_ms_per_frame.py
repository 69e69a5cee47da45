"""Device ms a profiled frame of the BVH traversal (K2, and K3 on a flat
table: every ``traverse2`` kernel)."""

from tracelib import TRAVERSAL, device_ms_per_frame


def read(trace: dict) -> float | None:
    return device_ms_per_frame(trace, TRAVERSAL)
