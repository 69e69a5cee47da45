"""The present's share of its bound, in %: the frozen bound of one present
of the traffic's mode at its render and output sizes (``bounds.present``,
bytes at the H100's published peak) over the present's device ms a
profiled frame; nothing for a mode without a frozen bound."""

import bounds
from tracelib import PRESENT, device_ms_per_frame


def read(trace: dict) -> float | None:
    ms = device_ms_per_frame(trace, PRESENT)
    t = trace["traffic"]
    if ms is None or not t["present"]:
        return None
    h, w = round(t["height"] * t["render_scale"]), round(t["width"] * t["render_scale"])
    bound = bounds.present(t["upscaler"], h, w, t["height"], t["width"])
    return None if bound is None else 100.0 * bound[0] / ms
