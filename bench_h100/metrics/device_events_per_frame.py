"""Device events (kernels, copies, fills) a profiled frame: the frame
loop's launches, the host's orchestration of ``draw``."""


def read(trace: dict) -> float | None:
    if not trace["events"]:
        return None
    return len(trace["events"]) / trace["frames"]
