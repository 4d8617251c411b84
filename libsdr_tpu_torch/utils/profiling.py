"""Tracing and profiling helpers (counterpart of
``libsdr_tpu.utils.profiling``).

- :func:`trace` runs ``torch.profiler`` over the block: CPU activity, and
  CUDA activity when a card is there; the trace is exported into
  ``log_dir`` as a Chrome trace (``trace.json``).
- :class:`StageTimer` is the quick host-side alternative: wall time per
  named region, the registered tensors' devices synchronised before the
  clock stops.
- :func:`span` (and :func:`spanned`, its decorator form) marks the
  program's own stages.  A span records only while a ``torch.profiler``
  session records (as inside :func:`trace`): it then enters
  ``torch.profiler.record_function``, so the profiler's trace holds it on
  its own clock beside the kernels, and appends a :class:`SpanRecord` to an
  in-memory store (:func:`records`, :func:`summary`, :func:`reset`).  With
  no profiler running a span is one attribute read and returns a shared
  no-op context.

The program's spans, by layer: ``pipeline`` (``Pipeline.apply``),
``chunked.run`` with ``chunked.capture`` / ``chunked.copy_in`` /
``chunked.replay`` (``ChunkedStep.run``), ``scanner.step`` with
``scanner.channelize`` / ``scanner.ask`` / ``scanner.pll`` /
``scanner.compact`` (``parallel/wideband.build_scanner_step``; the step
and the compaction with CUDA event pairs on the card, so ``summary()``
gives their device time), ``multimode.step`` with ``multimode.channelize``
/ ``multimode.chains`` / ``multimode.pll`` / ``multimode.psk31`` /
``multimode.compact`` (``parallel/multimode.build_multimode_step`` and
``ops/bitsync.apply_mode_chains``) and ``multimode.pack``
(``apps/multimode.pack_bank_outputs``; all but the channelizer and the
chains with event pairs on the card), ``stage:<Class>``
around each stage of a ``Pipeline`` or ``Tee``, and ``wrapper:<entry>``
around each kernel wrapper of ``core/graph.kernel_entries()``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler


# Its ``_is_profiler_enabled`` is True while a profiler session records (a
# private module flag, there in torch 2.11 and 2.13:
# tests/test_torch_tracing.py pins it; ``torch._C._autograd.
# _profiler_enabled()`` would read the same state at a call's cost).
_FLAG = torch.autograd.profiler

# Records the store holds before it counts the rest as dropped.
STORE_LIMIT = 1 << 20


class SpanRecord:
    """One span: ``name``, ``parent`` (the index in :func:`records` of the
    enclosing open span, or None), ``dispatch`` (the sequence number of the
    outermost span it sits in), ``t0_ns`` / ``t1_ns``
    (``time.perf_counter_ns``; ``t1_ns`` None while open) and, for a device
    span, a pair of timing CUDA events recorded on ``stream``, the stream
    current at its start (:attr:`device_ms`)."""

    __slots__ = ("name", "parent", "dispatch", "t0_ns", "t1_ns", "events",
                 "stream")

    def __init__(self, name, parent, dispatch, t0_ns, events, stream):
        self.name, self.parent, self.dispatch = name, parent, dispatch
        self.t0_ns, self.t1_ns = t0_ns, None
        self.events, self.stream = events, stream

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """The device time between the span's two events (waits for the
        second), or None for a host-only span."""
        if self.events is None or self.t1_ns is None:
            return None
        e0, e1 = self.events
        e1.synchronize()
        return e0.elapsed_time(e1)


class _Store:
    """The spans recorded in this process, in the order they opened; each
    thread nests its own spans."""

    def __init__(self, limit: int = STORE_LIMIT):
        self.limit = limit
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self._local = threading.local()
        self._dispatches = itertools.count()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, name: str, device: bool):
        stack = self._stack()
        if len(self.records) >= self.limit:
            self.dropped += 1
            stack.append(None)
            return None
        top = stack[-1] if stack else None
        events = stream = None
        if device and not torch.cuda.is_current_stream_capturing():
            # a timing event cannot be recorded into a graph capture; the
            # stream is looked up once for both events (each lookup costs
            # about 10 us under the profiler)
            stream = torch.cuda.current_stream()
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        rec = SpanRecord(
            name, None if top is None else top[0],
            next(self._dispatches) if top is None else top[1].dispatch,
            time.perf_counter_ns(), events, stream)
        if events is not None:
            events[0].record(stream)
        stack.append((len(self.records), rec))
        self.records.append(rec)
        return rec

    def close(self, rec) -> None:
        self._stack().pop()
        if rec is not None:
            if rec.events is not None:
                rec.events[1].record(rec.stream)
            rec.t1_ns = time.perf_counter_ns()


_STORE = _Store()


class _Span:
    """A live span: ``record_function`` and a store record."""

    __slots__ = ("name", "device", "_rf", "_store", "_rec")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._store = _STORE
        self._rec = self._store.open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        self._store.close(self._rec)
        self._rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A context for the stage ``name``: while a ``torch.profiler`` session
    records, a ``record_function`` of that name and a record in the store
    (``device=True``: with a pair of timing CUDA events on the current
    stream; pass it only for work on the card); otherwise one shared no-op
    context."""
    if not _FLAG._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def spanned(name: str):
    """:func:`span` as a decorator (a host span): the whole call of the
    function in a span, decided at each call.  The function's attributes
    (a kernel wrapper's ``launches`` and ``routes``) live on the returned
    one."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _FLAG._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, False):
                return fn(*args, **kwargs)
        return call
    return wrap


def records() -> List[SpanRecord]:
    """The spans recorded since the last :func:`reset`, in the order they
    opened (a record's ``parent`` indexes this list)."""
    return list(_STORE.records)


def dropped() -> int:
    """Spans not recorded because the store was full."""
    return _STORE.dropped


def summary() -> Dict[str, dict]:
    """Per span name over the closed records: ``calls``, ``host_ms``
    (total), ``self_host_ms`` (total less the child spans' intervals) and
    ``device_ms`` (the summed event intervals of device spans, else None;
    resolved here, after a synchronise)."""
    recs = records()
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    child = [0] * len(recs)
    for r in recs:
        if r.parent is not None and r.t1_ns is not None:
            child[r.parent] += r.t1_ns - r.t0_ns
    out: Dict[str, dict] = {}
    for r, c in zip(recs, child):
        if r.t1_ns is None:
            continue
        s = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                    "self_host_ms": 0.0, "device_ms": None})
        s["calls"] += 1
        s["host_ms"] += r.host_ms
        s["self_host_ms"] += (r.t1_ns - r.t0_ns - c) * 1e-6
        d = r.device_ms
        if d is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + d
    return out


def reset() -> None:
    """Forget every record and the dropped count; a new store holds
    :data:`STORE_LIMIT` records (a span open across the reset closes in the
    old one)."""
    global _STORE
    _STORE = _Store(STORE_LIMIT)


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
