"""op_host_ms (ms): the host's self time a block in the program's Op
spans (``stage:<Class>`` around each stage of a ``Pipeline`` or ``Tee``,
and the scanner step's ``scanner.channelize`` / ``ask`` / ``pll`` /
``compact``): each span's time less its child spans' (the kernel wrappers'
among them), from the program's ``utils/profiling`` records.  A program
without spans reports nothing."""


def _records():
    from libsdr_tpu_torch.utils import profiling
    get = getattr(profiling, "records", None)
    return get() if get is not None else []


def _op(name: str) -> bool:
    return name.startswith("stage:") or (name.startswith("scanner.")
                                         and name != "scanner.step")


def read(ctx):
    recs = _records()
    child = [0] * len(recs)
    for r in recs:
        if r.parent is not None and r.t1_ns is not None:
            child[r.parent] += r.t1_ns - r.t0_ns
    ns = [r.t1_ns - r.t0_ns - c for r, c in zip(recs, child)
          if _op(r.name) and r.t1_ns is not None]
    if not ns or not ctx.window.blocks:
        return None
    return sum(ns) * 1e-6 / ctx.window.blocks
