"""Idle device ms a frame while the host runs ``Renderer.draw`` outside its
sample and bounce loop (in ``mrt.draw``, not in ``mrt.trace.loop``): the
frame's set-up (scene sync, animation, camera, uniforms, prepare), the
trace's set-up and the accumulation (``spanlib``)."""

from spanlib import idle_ms_per_frame


def read(trace: dict) -> float | None:
    return idle_ms_per_frame(trace, "mrt.draw", outside="mrt.trace.loop")
