"""Host seconds of the run's BVH build, to the device's end of it: the
port's counter ``setup.bvh_build_s``."""

from spanlib import program_counters


def read(trace: dict) -> float | None:
    return program_counters().get("setup.bvh_build_s")
