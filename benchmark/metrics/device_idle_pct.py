"""device_idle_pct (%): the share of the traced window in which no kernel,
copy or memset ran on the card (torch.profiler's trace)."""


def read(ctx):
    tr = ctx.window.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
