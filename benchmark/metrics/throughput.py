"""throughput (Msamples/s): the complex input samples of every channel in
the blocks the window completed, over the window's length on the host's
clock (the window ends in a synchronise)."""

from benchmark import costs


def read(ctx):
    return costs.msps(ctx.window.blocks * ctx.samples_per_block,
                      ctx.window.seconds)
