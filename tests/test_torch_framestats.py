"""FrameStats keeps a bounded number of pending per-frame ray counts over a
long session, and its totals stay exact: every 1024 pending frames are
folded into one int64 sum on their device (the JAX package's
``FrameStats.record`` stacks its pending scalars every 1024 frames)."""

import numpy as np
import torch

from mrt_tpu_torch.engine.renderer import FOLD_FRAMES, FrameStats


def test_pending_bounded_and_totals_exact():
    stats = FrameStats()
    rng = np.random.default_rng(0)
    # counts near 2^31: an int32 running sum would wrap within a few frames
    counts = rng.integers(2 ** 30, 2 ** 31 - 1, size=3000)
    peak = 0
    for c in counts:
        stats.record(torch.tensor(int(c), dtype=torch.int64))
        peak = max(peak, len(stats._pending))
    assert FOLD_FRAMES == 1024
    assert peak < 1025 and len(stats._pending) < 1025
    assert all(t.dtype == torch.int64 for t in stats._pending)
    report = stats.report()
    assert report["frames"] == 3000
    assert report["total_rays"] == int(sum(int(c) for c in counts))
    assert not stats._pending
    # a report between records keeps the sum exact
    stats.record(torch.tensor(5, dtype=torch.int64))
    assert stats.report()["total_rays"] == int(sum(int(c) for c in counts)) + 5
