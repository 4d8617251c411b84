"""kernels_per_block (count): the kernels that ran on the card in the
traced window (torch.profiler's trace; copies and memsets apart) per block
the window completed, whoever launched them: the program's own kernels,
PyTorch's and those inside CUDA graph replays."""


def read(ctx):
    tr = ctx.window.trace
    if tr is None or not tr.kernels or not ctx.window.blocks:
        return None
    return tr.kernels / ctx.window.blocks
