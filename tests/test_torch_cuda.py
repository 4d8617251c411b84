"""The CUDA kernel of ``ops/fir_fm.py`` against its plain PyTorch version on
the card.  Every test carries the ``cuda`` marker and skips where there is no
CUDA device (the kernel has no CPU mode); on the card run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the test
configuration in tests/conftest.py imports JAX).

Bound: both versions compute in float32 with a different summation order
and share the atan2 polynomial, so on a constant-envelope FM input the audio
differs by ~1e-6 rad; an indexing or carry fault shows as errors of order 1.
"""

import numpy as np
import pytest
import torch

import libsdr_tpu_torch as P
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand, siggen
from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact, fir_fm_exact_plain

pytestmark = pytest.mark.cuda

FS = 960_000.0
ERR_BOUND = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _op(d, t, c, b, plane_dtype=None):
    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=min(FS / 4.8, 0.8 * FS / d),
                                order=t - d + 1, decim=d, design="textbook"),
                     FMDemod(), FMDeemph()])
    rx.bind(P.StreamSpec(np.complex64, FS, b, channels=(c,),
                         plane_dtype=plane_dtype))
    return rx.stages[0]


def _fm(c, b, d, k):
    dev = 0.15 * FS / d
    rows = [siggen.fm_modulate(
        FS, siggen.sine(FS, (k + 1) * b, 900.0 + 50 * ch, amps=1.0), dev,
        carrier=FS / 8 + 300.0 * ch)[k * b:] for ch in range(c)]
    return np.stack(rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deemph", [True, False])
@pytest.mark.parametrize("d,t,c", [(2, 37, 3), (4, 67, 64), (8, 67, 5),
                                   (1, 9, 2)])
def test_kernel_matches_plain(cuda, dtype, deemph, d, t, c):
    b = d * (5 * 2048 + 777)
    op = _op(d, t, c, b, dtype)
    carry = op.init_carry(cuda)
    # block 0 warms the carry up through the plain version: the zero-history
    # start of the test signal can put the discriminator exactly on its
    # +-pi branch cut, where the two versions may round to opposite sides
    for k in range(4):
        x = _fm(c, b, d, k)
        x = Complex(torch.tensor(x.real, device=cuda).to(dtype),
                    torch.tensor(x.imag, device=cuda).to(dtype))
        args = (x, op._taps(cuda), d, carry[0], carry[1], op._rot, op._gain)
        kw = dict(deemph_ab=op._dab if deemph else None,
                  dstate=carry[2] if deemph else None)
        ref, y_ref = fir_fm_exact_plain(*args, **kw)
        if k == 0:
            out, y_last = ref, y_ref
        else:
            n0 = fir_fm_exact.launches
            out, y_last = fir_fm_exact(*args, **kw)
            assert fir_fm_exact.launches == n0 + 1
        torch.cuda.synchronize()
        assert out.shape == (c, b // d) and bool(torch.isfinite(out).all())
        assert float((out - ref).abs().max()) < ERR_BOUND
        assert float((y_last.re - y_ref.re).abs().max()) < ERR_BOUND
        tail = x[..., b - (t - 1):].map(torch.clone)
        carry = (tail, y_last, out[..., -1] if deemph else carry[2])


def test_kernel_refuses_what_it_does_not_take(cuda):
    op = _op(4, 67, 2, 4096)
    carry = op.init_carry(cuda)
    x = Complex(torch.zeros(2, 8192, device=cuda)[:, ::2],
                torch.zeros(2, 4096, device=cuda))
    with pytest.raises(ValueError):
        fir_fm_exact(x, op._taps(cuda), 4, carry[0], carry[1], op._rot, 1.0)
    x = Complex(torch.zeros(2, 4096, device=cuda, dtype=torch.float64),
                torch.zeros(2, 4096, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        fir_fm_exact(x, op._taps(cuda), 4, carry[0], carry[1], op._rot, 1.0)
    # outside the shared-memory gate: 256*D + 2*T far above ~28,700
    d = 512
    x = Complex(torch.zeros(2, 4 * d, device=cuda),
                torch.zeros(2, 4 * d, device=cuda))
    taps = Complex(torch.zeros(67, device=cuda), torch.zeros(67, device=cuda))
    with pytest.raises(ValueError):
        fir_fm_exact(x, taps, d, carry[0], carry[1], op._rot, 1.0)


def test_pipeline_on_card_matches_cpu(cuda):
    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64,
                                decim=4, design="textbook"),
                     FMDemod(), FMDeemph()])
    rx.bind(P.StreamSpec(np.complex64, FS, 16384, channels=(4,)))
    cg, cc = rx.init_carry(cuda), rx.init_carry()
    for k in range(3):
        x = _fm(4, 16384, 4, k)
        n0 = fir_fm_exact.launches
        cg, yg = rx.apply(cg, Complex(torch.tensor(x.real, device=cuda),
                                      torch.tensor(x.imag, device=cuda)))
        assert fir_fm_exact.launches == n0 + 1
        cc, yc = rx.apply(cc, Complex(torch.tensor(x.real),
                                      torch.tensor(x.imag)))
        assert float((yg.cpu() - yc).abs().max()) < ERR_BOUND
