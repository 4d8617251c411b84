"""bank_psk31_device_pct (%): the PSK31 group (``multimode.psk31``: its
select on K1b and BPSK31's serial kernel), as a share of the bank's device
time (``multimode.step`` and ``multimode.pack``), each summed over the
traced window from the CUDA event pair the program's span records.  A
program without these spans reports nothing."""

from benchmark import spans

PART = ("multimode.psk31",)
WHOLE = ("multimode.step", "multimode.pack")


def read(ctx):
    return spans.device_share(PART, WHOLE)
