"""Device ms a profiled frame of the present's kernels (K9-K12 and K1, in
their uint8 forms where they end the chain)."""

from tracelib import PRESENT, device_ms_per_frame


def read(trace: dict) -> float | None:
    return device_ms_per_frame(trace, PRESENT)
