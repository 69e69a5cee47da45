"""The comparison that decides a run's ``correct``.

The last frame of the measured window is judged against the reference
(``reference/frame.py``), which follows the program's state before it, at
pixels drawn from the seed: the accumulated colour, depth, motion and
sample count of each drawn pixel, the frame's ray count against the drawn
pixels' mean, and, where the cell presents, every byte of the presented
image. The run's first frames are judged alike at a part of those pixels
against the reference's own first frames, which take nothing of the
program's. Each number has a limit (``LIMITS``; a traffic
file's ``limits`` may set its own), set between what sound runs of the port
read and what the control (the reference in bfloat16) reads; PERF.md gives
the readings each limit was set from.
"""

from __future__ import annotations

import torch

# a drawn pixel mismatches where its accumulated colour differs by more
# than ATOL + RTOL * |reference| in a channel, its depth by more than
# DEPTH_RTOL of the reference's (at least of 1), its motion by more than
# MOTION_ATOL + MOTION_RTOL * |reference| pixels, or its sample count at all.
# A path that takes another branch (a hit on an edge found by one BVH and
# not the other) mismatches; rounding alone stays far inside.
ATOL, RTOL = 1e-4, 1e-3
DEPTH_RTOL = 1e-4
MOTION_ATOL, MOTION_RTOL = 1e-3, 1e-3

LIMITS = {
    # the share of the drawn pixels that mismatch: sound runs read at most
    # 1.5e-4 (5 of 32,768 pixels), the control 0.24 and more
    "mismatch_share": 0.005,
    # |frame rays / pixels - the drawn pixels' mean| / that mean: sound runs
    # read at most 0.0096 (the drawn pixels' sampling error), half of the
    # frame's pixels left out 0.50
    "rays_gap": 0.05,
    # the share of the presented image's bytes that differ: an exact
    # comparison (sound runs 0, the control 0.0058 and more)
    "present_off_share": 0.0,
    # the share of the first frames' (frame, drawn pixel) pairs that
    # mismatch, against the reference's frames from the starting state
    "prefix_mismatch_share": 0.005,
}


def at_pixels(program, pixels: torch.Tensor, device):
    """The program's frame (``reference.frame.Program``) at the flat render
    pixels ``pixels``, as the reference's ``Expected``, and its rays per
    pixel over the whole frame."""
    from reference.frame import Expected

    pix = pixels.to(program.accum.device)

    def at(t, cols):
        return (t.reshape(-1, cols) if cols else t.reshape(-1))[pix].to(device)

    n_pixels = program.accum.shape[0] * program.accum.shape[1]
    got = Expected(at(program.accum, 3), at(program.depth, 0), at(program.motion, 2),
                   at(program.samples, 0), None, program.image)
    return got, program.rays / n_pixels


def mismatched(got, e) -> dict:
    """Per drawn pixel, whether ``got`` (an ``Expected``) departs from the
    reference's ``e`` in colour, depth, motion or sample count (bool (n,)
    tensors by part)."""
    acc, depth, motion = got.accum, got.depth, got.motion
    bad_acc = ((acc - e.accum).abs() > ATOL + RTOL * e.accum.abs()).any(dim=1)
    bad_acc |= ~torch.isfinite(acc).all(dim=1)
    bad_depth = (depth - e.depth).abs() > DEPTH_RTOL * torch.clamp(e.depth.abs(), min=1.0)
    bad_depth |= ~torch.isfinite(depth)
    bad_motion = ((motion - e.motion).abs() > MOTION_ATOL + MOTION_RTOL * e.motion.abs()).any(dim=1)
    bad_motion |= ~torch.isfinite(motion).all(dim=1)
    return {"colour": bad_acc, "depth": bad_depth, "motion": bad_motion,
            "samples": got.samples.to(e.samples.device) != e.samples}


def compare(got, rays_per_pixel: float, expected, present: bool) -> dict:
    """The numbers compared of the window's last frame, each a float:
    ``got`` (an ``Expected`` at the drawn pixels: the program's, or the
    control's) against the reference's ``expected``; ``rays_per_pixel``:
    got's frame rays over its pixels."""
    e = expected
    parts = mismatched(got, e)
    bad = parts["colour"] | parts["depth"] | parts["motion"] | parts["samples"]
    ref_mean = e.rays.double().mean().item()
    out = {
        "mismatch_share": bad.double().mean().item(),
        "rays_gap": abs(rays_per_pixel - ref_mean) / ref_mean,
    }
    if present:
        if got.image is None or tuple(got.image.shape) != tuple(e.image.shape):
            out["present_off_share"] = 1.0
        else:
            off = got.image.to(e.image.device) != e.image
            out["present_off_share"] = off.double().mean().item()
    out["parts"] = {k: v.double().mean().item() for k, v in parts.items()}
    return out


def compare_prefix(got: list, expected: list) -> dict:
    """``prefix_mismatch_share``: the share of (frame, drawn pixel) pairs
    of the first frames in which ``got`` departs from the reference's
    ``expected`` (each a list of ``Expected``, frame by frame); 1 where a
    frame is missing."""
    if len(got) != len(expected) or not got:
        return {"prefix_mismatch_share": 1.0}
    bad = []
    for g, e in zip(got, expected):
        parts = mismatched(g._replace(accum=g.accum.to(e.accum.device),
                                      depth=g.depth.to(e.depth.device),
                                      motion=g.motion.to(e.motion.device)), e)
        bad.append(parts["colour"] | parts["depth"] | parts["motion"] | parts["samples"])
    return {"prefix_mismatch_share": torch.cat(bad).double().mean().item()}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: [number, limit]})."""
    table = {k: [v, limits[k]] for k, v in numbers.items() if k in limits}
    return all(v <= lim for v, lim in table.values()), table
