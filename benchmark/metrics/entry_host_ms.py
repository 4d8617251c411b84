"""entry_host_ms (ms): the host's time inside the program's top-level span
a dispatch (``pipeline``, ``chunked.run`` or ``scanner.step``: the
program's own ``utils/profiling`` records, which hold exactly the traced
window's).  The in-program part of ``enqueue_ms``: the benchmark's event
records and the pager's ring copy stay outside.  A program without
spans reports nothing."""


def _records():
    from libsdr_tpu_torch.utils import profiling
    get = getattr(profiling, "records", None)
    return get() if get is not None else []


def read(ctx):
    top = [r for r in _records() if r.parent is None and r.t1_ns is not None]
    if not top or not ctx.window.dispatches:
        return None
    return sum(r.t1_ns - r.t0_ns for r in top) * 1e-6 / ctx.window.dispatches
