"""The device's side of a traced window, read from ``torch.profiler``'s
trace: the operations that ran on the card, when the card was busy, and
what the host was doing (the benchmark's own spans) in each idle gap."""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("entry", "wait")       # the benchmark's host spans; else "outside"
WINDOW = "window"


@dataclasses.dataclass
class Trace:
    window: tuple           # (start, end) in microseconds
    ops: list               # [(name, start, duration)] of device operations
    spans: list             # [(name, start, end)] of host spans
    kernels: int = 0        # of the operations, the kernels

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals in the window."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(s + d, hi)) for _, s, d in self.ops
                    if s < hi and s + d > lo)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    @property
    def op_s(self) -> float:
        """The device operations' summed time (overlaps counted twice)."""
        return sum(d for _, _, d in self.ops) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        for name, _, d in self.ops:
            tot[name] = tot.get(name, 0.0) + d * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time of the window by the host span its gaps start in
        (the host's spans follow one another, so the last one to start
        before a gap is the only one that can hold its start)."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [a for _, a, _ in spans]
        tot = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            k = bisect.bisect_right(starts, s) - 1
            name = spans[k][0] if k >= 0 and spans[k][2] > s else "outside"
            tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


def read(prof) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops, spans, window, kernels = [], [], None, 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((name, ts, dur))
            kernels += cat == "kernel"
        elif cat == "user_annotation":
            if name == WINDOW:
                window = (ts, ts + dur)
            elif name in SPANS:
                spans.append((name, ts, ts + dur))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(window, ops, spans, kernels)
