"""wrapper_host_ms (ms): the host's time a block inside the program's
kernel wrappers (``wrapper:<entry>`` spans around each call of a
``core/graph.kernel_entries()`` entry, a wrapper inside another counted
once), from the program's ``utils/profiling`` records.  A program without
spans reports nothing."""


def _records():
    from libsdr_tpu_torch.utils import profiling
    get = getattr(profiling, "records", None)
    return get() if get is not None else []


def read(ctx):
    recs = _records()
    wrapped = [r.name.startswith("wrapper:") for r in recs]
    ns = [r.t1_ns - r.t0_ns for r, w in zip(recs, wrapped)
          if w and r.t1_ns is not None
          and (r.parent is None or not wrapped[r.parent])]
    if not ns or not ctx.window.blocks:
        return None
    return sum(ns) * 1e-6 / ctx.window.blocks
