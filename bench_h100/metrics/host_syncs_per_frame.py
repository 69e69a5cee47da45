"""Device-to-host reads a draw on the frame's path: the port's counters
``host_syncs`` over ``frames``, whole-run totals (set-up, window and
profiled frames)."""

from spanlib import program_counters


def read(trace: dict) -> float | None:
    c = program_counters()
    if not c.get("frames") or "host_syncs" not in c:
        return None
    return c["host_syncs"] / c["frames"]
