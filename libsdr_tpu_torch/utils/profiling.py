"""Tracing and profiling helpers (counterpart of
``libsdr_tpu.utils.profiling``).

- :func:`trace` runs ``torch.profiler`` over the block: CPU activity, and
  CUDA activity when a card is there; the trace is exported into
  ``log_dir`` as a Chrome trace (``trace.json``).
- :class:`StageTimer` is the quick host-side alternative: wall time per
  named region, the registered tensors' devices synchronised before the
  clock stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the block into ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(value) -> None:
    """Wait for the card's work that produces ``value``: a tensor or a nest
    of them (tuples, lists, dicts, Complex, Ragged)."""
    from libsdr_tpu_torch.core.graph import _leaves
    for dev in {v.device for v in _leaves(value)[0]
                if isinstance(v, torch.Tensor) and v.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating wall-clock timer with device synchronization.

    The region yields a ``sync`` callable; register the values produced
    inside so the timer waits for their device before recording (the card
    runs asynchronously: without it only the launches would be timed):

    >>> t = StageTimer()
    >>> with t.region("fir") as sync:
    ...     y = step(c, x)
    ...     sync(y)
    >>> t.report()
    {'fir': {'calls': 1, 'total_s': ...}}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, tuple] = {}

    @contextlib.contextmanager
    def region(self, name: str):
        pending: list = []
        t0 = time.perf_counter()
        try:
            yield pending.append
        finally:
            for v in pending:
                _sync(v)
            dt = time.perf_counter() - t0
            calls, total = self._acc.get(name, (0, 0.0))
            self._acc[name] = (calls + 1, total + dt)

    def report(self) -> Dict[str, dict]:
        return {k: {"calls": c, "total_s": round(s, 6)}
                for k, (c, s) in self._acc.items()}
