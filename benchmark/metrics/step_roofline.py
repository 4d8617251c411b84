"""step_roofline (%): the least time of the traced window's blocks (the
larger of their bytes at the HBM peak and their float32 operations at the
float32 peak, as the configuration's ``cost`` counts them per input
sample) over the summed time of every device operation in the trace."""

from benchmark import costs


def read(ctx):
    tr = ctx.window.trace
    if tr is None or not tr.ops:
        return None
    samples = ctx.window.blocks * ctx.samples_per_block
    return 100.0 * costs.bound_s(ctx.config["cost"], samples) / tr.op_s
