"""bank_compact_device_pct (%): the bank's windowing and packing
(``multimode.compact``: ``core/ragged.compact_windows`` over the clocked
groups; ``multimode.pack``: ``apps/multimode.pack_bank_outputs``), the
pager's ``compaction_device_pct`` for the bank, as a share of the bank's
device time (``multimode.step`` and ``multimode.pack``), each summed over
the traced window from the CUDA event pair the program's span records.  A
program without these spans reports nothing."""

from benchmark import spans

PART = ("multimode.compact", "multimode.pack")
WHOLE = ("multimode.step", "multimode.pack")


def read(ctx):
    return spans.device_share(PART, WHOLE)
