"""``set_mxu_precision('fast')`` (one bf16 pass on the tensor-core route)
against ``'high'`` on the kernels without a discriminator to gain from,
K1b, K1c, K1d and K5, each on the route at both precisions: the cases as
the card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` run
them, and the gate both hold them to.

    from libsdr_tpu_torch.tools.fast_precision import (FAST_8BIT_DB,
                                                        fast_snr_db,
                                                        flat_cases)
    for name, entry, run in flat_cases(64):
        assert float(fast_snr_db(run, entry)[0]) >= FAST_8BIT_DB

The signals: the JAX package's own gate's FM signal (a 900 Hz tone at 75
kHz deviation on a 120 kHz carrier at 960 kHz, :func:`fm_tone`) through
the DDC bank's chain (K1b, IQBaseBand alone, D = 4) and F1's call (K5,
``fir_overlap_save`` of a 67-tap band-pass at offset 0, D = 4); a 900 Hz
tone at 50% AM through the AM bank's chain (K1c, ``rx_stages("AM")``,
D = 40); two tones in the upper sideband through the USB bank's chain
(K1d, ``rx_stages("USB")``, D = 80, in the plane dtype its cut puts on
the route).  One pass keeps an 8-bit source's fidelity, FAST_8BIT_DB, as
the JAX kernel describes 'fast' (``pallas_fir_mxu.py::_make_mm``).  Needs
one CUDA card and nvcc.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex

FS = 960_000.0
FAST_8BIT_DB = 6.02 * 8 + 1.76   # an 8-bit source's SNR
F1_T, F1_D = 67, 4               # F1's band-pass and stride
AM_BLOCK = 40 * 3277
USB_BLOCK = 80 * 3277


def planes(iq: np.ndarray, n_ch: int, dtype=torch.float32,
           device="cuda") -> Complex:
    """The complex signal iq on n_ch channels, in planes of dtype."""
    return Complex(torch.tensor(np.tile(iq.real[None], (n_ch, 1)),
                                dtype=torch.float32, device=device),
                   torch.tensor(np.tile(iq.imag[None], (n_ch, 1)),
                                dtype=torch.float32, device=device)).to(dtype)


def fm_tone(n_ch: int, block: int, device="cuda") -> Complex:
    """The JAX gate's FM signal (tests/test_tpu_smoke.py::
    test_fast_precision_mode_on_chip) on n_ch channels of block samples."""
    from libsdr_tpu_torch.ops import siggen

    audio = siggen.sine(FS, block + 4096, 900.0, amps=0.7)
    return planes(siggen.fm_modulate(FS, audio, deviation=75_000.0,
                                     carrier=120_000.0)[:block], n_ch,
                  device=device)


def _power(y, ref=None) -> torch.Tensor:
    """|y - ref|^2 (|y|^2 without ref) in float64, by output."""
    parts = (y.re, y.im) if isinstance(y, Complex) else (y,)
    refs = (((ref.re, ref.im) if isinstance(ref, Complex) else (ref,))
            if ref is not None else (None,) * len(parts))
    return sum((v.double() - (0.0 if r is None else r.double())) ** 2
               for v, r in zip(parts, refs))


def fast_snr_db(run, entry) -> torch.Tensor:
    """10 log10 of the power of run() at 'high' over that of its change at
    'fast', by channel (float64).  Raises AssertionError where the 'fast'
    call leaves entry's tensor-core route or equals 'high'."""
    from libsdr_tpu_torch.ops.fir import set_mxu_precision

    high = run()
    try:
        set_mxu_precision("fast")
        n0 = entry.routes["tc"]
        fast = run()
        torch.cuda.synchronize()
        assert entry.routes["tc"] == n0 + 1, (
            f"'fast' {entry.__name__} off the tc route")
    finally:
        set_mxu_precision("high")
    p_err = _power(fast, high).mean(dim=1)
    assert bool((p_err > 0).all()), f"'fast' equals 'high' ({entry.__name__})"
    return 10 * torch.log10(_power(high).mean(dim=1) / p_err)


def chain(stages, x: Complex, block: int):
    """A call of the pipeline of stages() on x, bound at FS in x's plane
    dtype: run() -> its output."""
    import libsdr_tpu_torch as P

    def run():
        rx = P.Pipeline(stages())
        rx.bind(P.StreamSpec(
            np.complex64, FS, block, channels=(x.re.shape[0],),
            plane_dtype=None if x.re.dtype == torch.float32
            else x.re.dtype))
        return rx.compile()(rx.init_carry(x.re.device), x)[1]
    return run


def flat_cases(n_ch: int, usb_dtype=torch.bfloat16, block: int = 1 << 17,
               device="cuda"):
    """[(kernel, entry, run)] of K1b, K1c, K1d (usb_dtype planes) and K5 on
    n_ch channels, the FM signal block samples long."""
    from libsdr_tpu_torch.apps.chains import rx_stages
    from libsdr_tpu_torch.ops import IQBaseBand, firdesign
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops.fir import fir_overlap_save

    tone = fm_tone(n_ch, block, device)
    t = np.arange(AM_BLOCK) / FS
    am = planes((1 + 0.5 * np.cos(2 * np.pi * 900.0 * t))
                * np.exp(2j * np.pi * 120_000.0 * t), n_ch, device=device)
    tu = np.arange(USB_BLOCK) / FS
    usb = planes(np.exp(2j * np.pi * 121_000.0 * tu)
                 + 0.3 * np.exp(2j * np.pi * 122_300.0 * tu), n_ch,
                 usb_dtype, device)
    g = firdesign.complex_bandpass(F1_T, 120_000.0, 200_000.0, FS)
    zt = Complex(torch.zeros(n_ch, F1_T - 1, device=device),
                 torch.zeros(n_ch, F1_T - 1, device=device))
    return [
        ("K1b", F.fir_exact, chain(lambda: [IQBaseBand(
            fc=120_000, width=200_000, order=64, decim=4,
            design="textbook")], tone, block)),
        ("K1c", F.fir_am_exact,
         chain(lambda: rx_stages("AM", FS, 120_000.0), am, AM_BLOCK)),
        ("K1d", F.fir_usb_exact,
         chain(lambda: rx_stages("USB", FS, 120_000.0), usb, USB_BLOCK)),
        ("K5", M.fir_mxu,
         lambda: fir_overlap_save(g, tone, zt, stride=F1_D, offset=0)[0])]
