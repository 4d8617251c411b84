"""compaction_device_pct (%): the pager scanner's on-device compaction
(``scanner.compact``: the windowing of the PLL's bits and valid flags,
the gather into channel order, the transposes and the packing) as a share
of the whole step's device time (``scanner.step``), each summed over the
traced window from the CUDA event pair the program's span records.  A
program without these spans reports nothing."""


def _records():
    from libsdr_tpu_torch.utils import profiling
    get = getattr(profiling, "records", None)
    return get() if get is not None else []


def read(ctx):
    tot = {"scanner.compact": 0.0, "scanner.step": 0.0}
    for r in _records():
        if r.name in tot:
            d = r.device_ms
            if d is None:
                return None
            tot[r.name] += d
    if not tot["scanner.step"]:
        return None
    return 100.0 * tot["scanner.compact"] / tot["scanner.step"]
