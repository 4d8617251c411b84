"""The program's span records (``libsdr_tpu_torch/utils/profiling``) as the
span metrics read them: nothing from a program without them."""

from __future__ import annotations


def records() -> list:
    """The records of the traced window, or [] where the program keeps
    none."""
    from libsdr_tpu_torch.utils import profiling
    get = getattr(profiling, "records", None)
    return get() if get is not None else []


def device_share(part, whole):
    """100 x the device ms of the spans named in ``part`` over those named
    in ``whole``, each summed over the records; None where a span of
    either has no device time (a host span, or the CPU) or none of
    ``part`` ran."""
    tot = dict.fromkeys(tuple(part) + tuple(whole), 0.0)
    seen = 0
    for r in records():
        if r.name in tot:
            d = r.device_ms
            if d is None:
                return None
            tot[r.name] += d
            seen += r.name in part
    den = sum(tot[k] for k in whole)
    if not seen or not den:
        return None
    return 100.0 * sum(tot[k] for k in part) / den
