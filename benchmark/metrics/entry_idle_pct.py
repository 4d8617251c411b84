"""entry_idle_pct (%): the share of the traced window in which the card
is idle (no kernel, copy or memset in torch.profiler's trace) while the
host is inside the program's top-level span (``pipeline``,
``chunked.run`` or ``scanner.step``, from the program's
``utils/profiling`` records).

The records carry the host's ``perf_counter`` clock, which the exported
trace does not share, so they are placed on the trace's clock dispatch by
dispatch: the k-th top-level record starts where the k-th of the
benchmark's ``"entry"`` spans starts, and each span under it keeps its
offset from it.  Where the two counts differ there is no placement and
no reading.  The program's top-level span in fact opens a little after
the benchmark's entry (its event record on a side stream, the call, the
pager's ``place``), so each placed span sits early by that lead: its
median 26-89 us in the FM cells and 140-201 us in the pager's, at most
the entry's length less the span's, on an NVIDIA H100 host under the
profiler (the program's own annotations in the exported trace).  Placed
so, this reading came within 0.15 points of the one placed by those
annotations in the three cells (capture, pager, stream: 0.032 against
0.022, 1.063 against 1.038, 3.10 against 3.25 %).

:func:`idle_by_span` gives the same idle time by the innermost program
span that holds it ("outside": in no program span); PERF.md's idle table
reads it.  A program without spans reports nothing."""

import bisect


def _records():
    from libsdr_tpu_torch.utils import profiling
    get = getattr(profiling, "records", None)
    return get() if get is not None else []


def _idle(tr) -> list:
    """The window's idle intervals (us), in order."""
    lo, hi = tr.window
    edges = [lo] + [x for iv in tr.busy_intervals() for x in iv] + [hi]
    return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]


def _overlap(ivs: list, starts: list, a: float, b: float) -> float:
    """The length of [a, b] inside the sorted disjoint intervals ``ivs``."""
    tot, k = 0.0, max(bisect.bisect_right(starts, a) - 1, 0)
    while k < len(ivs) and ivs[k][0] < b:
        tot += max(0.0, min(b, ivs[k][1]) - max(a, ivs[k][0]))
        k += 1
    return tot


def placed(ctx):
    """[(name, depth, start, end)] of the closed program spans on the
    trace's clock (us), each dispatch's in the order they opened; None
    without a device trace, without records, or where the top-level
    records and the "entry" spans differ in number."""
    tr = ctx.window.trace
    recs = _records()
    if tr is None or not tr.ops or not recs:
        return None
    entries = sorted(s for n, s, _ in tr.spans if n == "entry")
    tops = [i for i, r in enumerate(recs) if r.parent is None]
    if len(tops) != len(entries):
        return None
    at = dict(zip(tops, entries))
    top, depth = list(range(len(recs))), [0] * len(recs)
    for i, r in enumerate(recs):        # a parent opens before its children
        if r.parent is not None:
            top[i], depth[i] = top[r.parent], depth[r.parent] + 1

    def us(i, t_ns):        # on the trace's clock: the offset in whole ns
        return at[top[i]] + (t_ns - recs[top[i]].t0_ns) * 1e-3
    return [(r.name, depth[i], us(i, r.t0_ns), us(i, r.t1_ns))
            for i, r in enumerate(recs) if r.t1_ns is not None]


def read(ctx):
    spans = placed(ctx)
    if spans is None:
        return None
    tr = ctx.window.trace
    idle = _idle(tr)
    starts = [s for s, _ in idle]
    inside = sum(_overlap(idle, starts, s, e)
                 for _, d, s, e in spans if d == 0)
    return 100.0 * inside * 1e-6 / tr.window_s


def idle_by_span(ctx):
    """{span name or "outside": idle seconds} over the window, each idle
    instant given to the innermost program span open at it; None where
    :func:`placed` gives nothing."""
    spans = placed(ctx)
    if spans is None:
        return None
    idle = _idle(ctx.window.trace)
    starts = [s for s, _ in idle]
    out = {"outside": sum(e - s for s, e in idle) * 1e-6}
    stack, cursor = [], None

    def give(name, a, b):
        t = _overlap(idle, starts, a, b) * 1e-6 if b > a else 0.0
        if t:
            out[name] = out.get(name, 0.0) + t
            out["outside"] -= t
    # the spans of one thread nest: a sweep over their edges finds, between
    # two edges, the innermost one open
    for name, depth, s, e in sorted(spans, key=lambda x: (x[2], x[1])):
        while stack and stack[-1][1] <= s:
            n, end = stack.pop()
            give(n, cursor, end)
            cursor = end
        if stack:
            give(stack[-1][0], cursor, s)
        stack.append((name, e))
        cursor = s
    while stack:
        n, end = stack.pop()
        give(n, cursor, end)
        cursor = end
    return out
