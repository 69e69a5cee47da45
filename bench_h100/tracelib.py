"""What the per-layer readers (``metrics/<name>.py``) share: sums over a
traced run's profile.

A trace (``run.profile``) holds ``events``, the profiled frames' device
events as (name, start µs, duration µs); ``host``, the host's events alike;
``frames``, the number of profiled frames; ``wall_s``, their wall time;
``frame_wall_s``, the unprofiled window's mean frame wall; ``counters``,
the port's launch counts over the profiled frames; and the cell's
``traffic``, ``config`` and ``cell`` entries.
"""

from __future__ import annotations

# device kernels by layer, matched as substrings of the profiler's kernel
# names (csrc/*.cu of the port)
TRAVERSAL = ("traverse2",)
SHADE = ("sample_start", "shade_hit", "resolve_shadow")
# the temporal present (K12 bilinear, then K11 in its uint8 form)
PRESENT = ("resize", "temporal_resolve")


def device_ms_per_frame(trace: dict, names) -> float | None:
    """Device ms a profiled frame of the kernels whose names hold one of
    ``names``; None where the profile holds none of them."""
    picked = [d for n, _, d in trace["events"] if any(s in n for s in names)]
    if not picked:
        return None
    return sum(picked) / 1e3 / trace["frames"]


def busy_seconds(events) -> float:
    """Seconds in which some device event ran: the union of their spans
    (one stream, so nearly their sum)."""
    spans = sorted((s, s + d) for _, s, d in events)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6
