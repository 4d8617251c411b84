"""wrapper_calls_per_block (count): calls of the port's kernel wrappers
per block in the window, counted where they happen (each wrapper's
``launches``, ``core/graph.kernel_entries``) and, for CUDA graph replays,
as a capture's wrapper calls times its replays
(``ChunkedStep.graph_launches``).  One wrapper call may launch several
kernels: ``kernels_per_block`` counts those."""


def read(ctx):
    w = ctx.window
    return w.launches / w.blocks if w.blocks else None
