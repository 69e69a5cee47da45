"""What the readers of the port's own spans and counters share.

The port marks the stages of its frame with spans (``mrt_tpu_torch/utils/
telemetry.py``): host events named ``mrt.*`` that ``torch.profiler`` keeps
on its own clock, so they land in a trace's ``host`` list (``run.profile``,
``tracelib``) beside the device events. A stage's idle time is the part of
the profiled frames' idle device time (the gaps between consecutive device
events, from the first to the last) that its spans cover. The idle readers
scale that part by the stage's share of the profiled idle to the unprofiled
idle a frame, ``frame_wall_s - busy / frames``, as ``idle_share`` reads the
idle, so that the stages and the unspanned rest add up to ``idle_share *
frame_wall_s``. The counters are the port's whole-run totals, read from its
module while the run is live. A program without the spans or the counters
reads as nothing (None).
"""

from __future__ import annotations

from tracelib import busy_seconds


def idle_gaps(events) -> list[tuple[float, float]]:
    """The gaps (start, end in µs) between the device events' union, from
    the first event to the last, in order."""
    gaps, end = [], None
    for s, e in sorted((s, s + d) for _, s, d in events):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def intervals(trace: dict, name: str) -> list[tuple[float, float]]:
    """The (start, end) µs of the host events named ``name``, in order."""
    return sorted((s, s + d) for n, s, d in trace["host"] if n == name)


def overlap_us(gaps, spans) -> float:
    """µs where two sorted lists of disjoint intervals overlap."""
    total, j = 0.0, 0
    for g0, g1 in gaps:
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < g1:
            total += max(0.0, min(g1, spans[k][1]) - max(g0, spans[k][0]))
            k += 1
    return total


def idle_us(trace: dict, inside: str, outside: str | None = None) -> float | None:
    """Profiled idle µs inside the spans ``inside`` and, where given, outside
    the spans ``outside`` (which lie within them); None where the profile
    holds no device event or the program none of the spans."""
    if not trace["events"]:
        return None
    spans = intervals(trace, inside)
    out = intervals(trace, outside) if outside else []
    if not spans or (outside and not out):
        return None
    gaps = idle_gaps(trace["events"])
    return overlap_us(gaps, spans) - (overlap_us(gaps, out) if outside else 0.0)


def idle_ms_per_frame(trace: dict, inside: str, outside: str | None = None) -> float | None:
    """``idle_us(trace, inside, outside)`` as its share of the profiled idle,
    times the unprofiled idle a frame, in ms."""
    part = idle_us(trace, inside, outside)
    if part is None:
        return None
    profiled = sum(e - s for s, e in idle_gaps(trace["events"]))
    if profiled <= 0.0:
        return 0.0
    idle_s = trace["frame_wall_s"] - busy_seconds(trace["events"]) / trace["frames"]
    return part / profiled * idle_s * 1e3


def innermost(trace: dict, prefix: str = "mrt.") -> list[tuple[float, float, str]]:
    """The time the spans named ``prefix*`` cover, cut into (start, end,
    name) pieces, each named by the innermost span over it (spans on the
    host thread nest), in order."""
    spans = sorted(((s, s + d, n) for n, s, d in trace["host"] if n.startswith(prefix)),
                   key=lambda x: (x[0], -x[1]))
    pieces, stack, t = [], [], 0.0

    def emit(name, a, b):
        if b > a:
            pieces.append((a, b, name))

    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            n, end = stack.pop()
            emit(n, t, end)
            t = end
        if stack:
            emit(stack[-1][0], t, s)
        stack.append((name, min(e, stack[-1][1]) if stack else e))
        t = s
    while stack:
        n, end = stack.pop()
        emit(n, t, end)
        t = end
    return pieces


def idle_by_span(trace: dict) -> dict:
    """Profiled idle µs by the innermost ``mrt.*`` span over it, and under
    ``"(no span)"`` the idle no span covers."""
    gaps = idle_gaps(trace["events"])
    out: dict = {}
    j = 0
    for s, e, name in innermost(trace):
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        part, k = 0.0, j
        while k < len(gaps) and gaps[k][0] < e:
            part += max(0.0, min(e, gaps[k][1]) - max(s, gaps[k][0]))
            k += 1
        if part:
            out[name] = out.get(name, 0.0) + part
    out["(no span)"] = sum(e - s for s, e in gaps) - sum(out.values())
    return out


def program_counters() -> dict:
    """The port's counters (``telemetry.counters``) so far in this process;
    empty where the port has none."""
    try:
        from mrt_tpu_torch.utils import telemetry
    except ImportError:
        return {}
    return dict(telemetry.counters)
