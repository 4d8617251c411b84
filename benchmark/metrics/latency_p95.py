"""latency_p95 (ms): the 95th percentile over the window's dispatches of
the time from the host handing a dispatch its blocks to its output being
ready, read from CUDA events on the device's clock."""

from benchmark import costs


def read(ctx):
    lat = ctx.window.latencies_ms
    return costs.percentile(lat, 95.0) if lat else None
