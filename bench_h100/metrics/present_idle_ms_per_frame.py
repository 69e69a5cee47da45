"""Idle device ms a frame while the host runs the present
(``mrt.present``: ``present_device`` and its kernel wrappers, ``spanlib``)."""

from spanlib import idle_ms_per_frame


def read(trace: dict) -> float | None:
    return idle_ms_per_frame(trace, "mrt.present")
