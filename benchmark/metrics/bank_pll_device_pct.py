"""bank_pll_device_pct (%): the banked bit clocks (``multimode.pll``:
``ops/bitsync.bitstream_bank_apply``, K3 and the passes around it), as a
share of the bank's device time (``multimode.step`` and
``multimode.pack``), each summed over the traced window from the CUDA
event pair the program's span records.  A program without these spans
reports nothing."""

from benchmark import spans

PART = ("multimode.pll",)
WHOLE = ("multimode.step", "multimode.pack")


def read(ctx):
    return spans.device_share(PART, WHOLE)
