"""dispatch_p95_ms (ms): the 95th percentile over the window's dispatches of
the time from the host handing a dispatch its blocks to its output being
ready (CUDA events on the device's clock), read per layer in a cell whose
``latency_p95`` is not end to end: the stream's 2 dispatches in flight make
it twice a dispatch's device time, less the host's hand-over."""

from benchmark import costs


def read(ctx):
    lat = ctx.window.latencies_ms
    return costs.percentile(lat, 95.0) if lat else None
