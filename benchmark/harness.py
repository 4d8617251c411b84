"""One run of one cell: set-up, the measured window, the comparison, and the
result line.

A system driver (``benchmark/systems/<system>.py``) holds the program and
its inputs on the device; the window here hands it dispatches in turn,
with at most the traffic's ``in_flight`` of them not yet done, for
``seconds`` seconds, and ends in a synchronise.  Each dispatch is timed on
the device from when the host hands it over (an event on an idle side
stream) to when its output is ready (an event after its work, read-back
included).  With a trace, the window runs under ``torch.profiler`` with the
benchmark's host spans ("entry": inside the program's entry call; "wait":
waiting for a dispatch to finish) as annotations, and is at most
``TRACE_SECONDS`` long.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time

import torch

from benchmark import signals
from benchmark import trace as trace_mod

TRACE_SECONDS = 2.0


@dataclasses.dataclass
class Window:
    seconds: float
    blocks: int
    dispatches: int
    latencies_ms: list
    entry_s: float
    launches: int
    trace: object = None


@dataclasses.dataclass
class Context:
    """What a metric's reader (``benchmark/metrics/<name>.py``) reads."""
    config: dict
    traffic: dict
    window: Window
    setup_s: float
    samples_per_block: int


class Spans:
    """The benchmark's host spans: profiler annotations when traced, and
    the host time inside the entry summed."""

    def __init__(self, profiled: bool):
        self.profiled = profiled
        self.entry_s = 0.0

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        ctx = (torch.profiler.record_function(name) if self.profiled
               else contextlib.nullcontext())
        with ctx:
            yield
        if name == "entry":
            self.entry_s += time.perf_counter() - t


def drive(system, seconds: float, in_flight: int, device,
          profiled: bool = False) -> Window:
    """Dispatch ``system`` for ``seconds`` (and at least its
    ``min_dispatches`` times); the window ends once every dispatch is done."""
    cuda = device.type == "cuda"
    spans = Spans(profiled)
    side = torch.cuda.Stream(device) if cuda else None
    lat, pending = [], collections.deque()
    l0 = system.launches()

    def retire():
        hand, done = pending.popleft()
        with spans("wait"):
            if cuda:
                done.synchronize()
                lat.append(hand.elapsed_time(done))
            else:
                lat.append((done - hand) * 1e3)

    window = (torch.profiler.record_function(trace_mod.WINDOW) if profiled
              else contextlib.nullcontext())
    with window:
        t0 = time.perf_counter()
        i = 0
        while i < system.min_dispatches or time.perf_counter() - t0 < seconds:
            while len(pending) >= in_flight:
                retire()
            with spans("entry"):
                if cuda:
                    hand = torch.cuda.Event(enable_timing=True)
                    hand.record(side)
                else:
                    hand = time.perf_counter()
                system.dispatch(i)
                if cuda:
                    done = torch.cuda.Event(enable_timing=True)
                    done.record()
                else:
                    done = time.perf_counter()
            pending.append((hand, done))
            i += 1
        while pending:
            retire()
        if cuda:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    return Window(t1 - t0, i * system.blocks_per_dispatch, i, lat,
                  spans.entry_s, system.launches() - l0)


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, planes: str = None, stamps=()) -> dict:
    """Set up, measure and judge one run of ``cell`` on ``device``; returns
    the result object (``reference_s``, the seconds the comparison took
    after the window; ``setup_parts``, the seconds of each part of
    set-up from ``t_start`` and the caller's ``stamps`` of (part, end
    time) on, and ``compared`` last).  ``planes`` replaces the
    configuration's plane precision (the control's lower precision)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stamps = [("start", t_start)] + list(stamps)

    def stamp(name: str) -> None:
        if cuda:
            torch.cuda.synchronize(device)
        stamps.append((name, time.perf_counter()))
    stamps.append(("imports", time.perf_counter()))
    if cuda:
        torch.empty(1, device=device)           # the CUDA context
    stamp("context")
    made = signals.make(cell.config, cell.traffic, seed, device,
                        root=cell.root)
    stamp("traffic")
    system = cell.module("systems", cell.config["system"]).System(
        cell.config, cell.traffic, made, seed, device, planes)
    stamp("program")
    system.warm()
    stamp("warm")
    setup_s = stamps[-1][1] - t_start
    parts = {n: b - a for (_, a), (n, b) in zip(stamps, stamps[1:])}
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    in_flight = int(cell.traffic["in_flight"])
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            win = drive(system, min(seconds, TRACE_SECONDS), in_flight,
                        device, profiled=True)
        win.trace = trace_mod.read(prof)
        del prof
    else:
        win = drive(system, seconds, in_flight, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t_judge = time.perf_counter()
    judged = system.judge()
    reference_s = time.perf_counter() - t_judge
    ctx = Context(cell.config, cell.traffic, win, setup_s,
                  system.samples_per_block)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.module("metrics", m["name"]).read(ctx)
        if v is None:
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if m["name"].startswith("latency"):
            metrics[m["name"]]["count"] = len(win.latencies_ms)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(_finite(v) and v <= lim
                             for v, lim in judged.values()),
              "attempted": win.blocks, "failed": 0, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = {"device_ops": win.trace.top_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["reference_s"] = reference_s
    result["setup_parts"] = parts
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in judged.items()}
    return result
