"""Device ms a profiled frame of the wavefront's stages: K6
``sample_start``, K7 ``shade_hit`` (every instantiation), K8
``resolve_shadow``."""

from tracelib import SHADE, device_ms_per_frame


def read(trace: dict) -> float | None:
    return device_ms_per_frame(trace, SHADE)
