"""enqueue_ms (ms): the host's time inside the program's entry call, per
dispatch (the benchmark's own span around it)."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.entry_s / w.dispatches if w.dispatches else None
