"""Spans and counters of the port's frame: the one tracing module.

``span(name)`` marks a stage of the frame for ``torch.profiler``. While a
profiler is recording it is a ``torch._C._profiler._RecordFunctionFast``,
which the profiler keeps as an ordinary host event, on its own clock beside
the aten ops and the device events, so a reader of a profile can put each
idle gap of the device down to the stage the host was in. Otherwise it is
one shared no-op context. The profiler is the only switch. Names start with
``mrt.``; nesting on the host thread stands for "the span that caused it",
and a frame is the order of its ``mrt.draw`` span.

``count(name, n)`` adds to ``counters``, always on: each is one add of a
value the host already holds (a stage adds its per-step sums once, after
its loop). ``timed(name)`` adds host seconds to ``counters``; only set-up
uses it, once a run. The counters are the process's, over every renderer;
``reset()`` clears them.

| Span | Where |
|---|---|
| ``mrt.draw`` | all of ``Renderer.draw`` |
| ``mrt.draw.setup`` | settings, scene sync, animation, camera, uniforms, ``prepare`` |
| ``mrt.trace.setup`` | ``trace_frame`` and ``trace_pixels`` before and after the loop |
| ``mrt.trace.loop`` | the sample and bounce loop of ``trace_pixels`` |
| ``mrt.sample_start``, ``mrt.closest``, ``mrt.shade``, ``mrt.any_hit``, ``mrt.resolve``, ``mrt.sample0`` | the loop's stages (``mrt.sample0``: sample 0's depth, motion and extra-sample decision) |
| ``mrt.lane_rows``, ``mrt.lane_occluded`` | geometry sharding's hit and occlusion combines |
| ``mrt.sync.live``, ``mrt.sync.extra`` | each host read of a device value in the loop |
| ``mrt.accumulate`` | ``accumulate`` and the frame's stats |
| ``mrt.present`` | all of ``present_device`` |
| ``mrt.resize``, ``mrt.temporal_resolve``, ``mrt.svgf_reproject``, ``mrt.atrous_pass``, ``mrt.tonemap_quantize`` | the present's kernel wrappers (K12, K11, K9, K10, K1) |

| Counter | What |
|---|---|
| ``frames`` | draws |
| ``host_syncs`` | device-to-host reads on the frame's path (the ``mrt.sync.*`` sites) |
| ``loop_steps`` | steps of the bounce loop |
| ``live_lanes`` | the lanes each step runs over, summed over steps |
| ``lane_slots`` | the batch's lanes, summed over steps |
| ``extra_samples`` | motion-adaptive extra samples (lanes over the extra levels) |
| ``setup.scene_compile_s``, ``setup.bvh_build_s``, ``setup.kernel_load_s`` | host seconds of ``Scene.compile``, the BVH build (the device synchronised at its end) and the kernels' first load |
"""

from __future__ import annotations

import contextlib
import time

import torch

counters: dict = {}  # name -> int (counts) or float (seconds), since the process or reset()

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_Span = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that records ``name`` as a host event while a
    ``torch.profiler`` records, and the shared no-op context otherwise."""
    if _profiling():
        return _Span(name)
    return _OFF


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def timed(name: str):
    """Add the host seconds of the block to the counter ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        count(name, time.perf_counter() - t0)


def reset() -> None:
    """Clear every counter."""
    counters.clear()
