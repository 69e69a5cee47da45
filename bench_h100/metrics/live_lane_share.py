"""The share of the wavefront's lane slots that its steps run over: the
port's counters ``live_lanes`` (the live lanes of each step of the bounce
loop) over ``lane_slots`` (the batch's lanes, each step), whole-run
totals."""

from spanlib import program_counters


def read(trace: dict) -> float | None:
    c = program_counters()
    if not c.get("lane_slots") or "live_lanes" not in c:
        return None
    return c["live_lanes"] / c["lane_slots"]
