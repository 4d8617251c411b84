"""bank_host_ms (ms): the host's time a dispatch inside the multi-mode
bank's top-level spans, ``multimode.step`` (``parallel/multimode``'s step)
and ``multimode.pack`` (``apps/multimode.pack_bank_outputs``), from the
program's ``utils/profiling`` records, which hold exactly the traced
window's.  A program without these spans reports nothing."""

from benchmark import spans

TOP = ("multimode.step", "multimode.pack")


def read(ctx):
    top = [r for r in spans.records() if r.parent is None and r.name in TOP
           and r.t1_ns is not None]
    if not top or not ctx.window.dispatches:
        return None
    return sum(r.t1_ns - r.t0_ns for r in top) * 1e-6 / ctx.window.dispatches
