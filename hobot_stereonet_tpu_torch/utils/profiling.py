"""Stage timers and the device trace.

Counterpart of ``hobot_stereonet_tpu/utils/profiling.py``: ``StageTimer``
is the same host-clock accumulator; ``device_trace`` wraps
``torch.profiler`` (CPU and CUDA activities) instead of ``jax.profiler``.
Unlike the reference, a trace that cannot start raises: a run that asked
for the device's timeline must not go on without it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class StageTimer:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_ms": round(self.totals[name] * 1e3, 3),
                "mean_ms": round(self.totals[name] / max(self.counts[name], 1) * 1e3, 3),
                "count": self.counts[name],
            }
            for name in self.totals
        }


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Trace the block with ``torch.profiler`` when ``logdir`` is set.

    Yields the profiler (``None`` without ``logdir``); after the block its
    ``key_averages()`` hold per-op host and device times, and the Chrome
    trace is in ``<logdir>/trace.json``.  Where CUDA is available the trace
    has the CUDA activity too: the device's kernels and copies.
    """
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()            # raises if the profiler cannot start
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
