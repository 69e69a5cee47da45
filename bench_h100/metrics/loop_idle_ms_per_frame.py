"""Idle device ms a frame while the host runs the sample and bounce loop
(the port's ``mrt.trace.loop`` spans): the launches, the per-step
live-lane reads and the extra-sample starts (``spanlib``)."""

from spanlib import idle_ms_per_frame


def read(trace: dict) -> float | None:
    return idle_ms_per_frame(trace, "mrt.trace.loop")
