"""The port's fused FIR + FM (+ de-emphasis) op against the JAX package's
Pallas kernel (``pallas_fir_mxu.fir_fm_exact``, interpret mode) and against
the per-window numpy oracle of tests/test_pallas.py.

On CPU tensors ``libsdr_tpu_torch.ops.fir_fm.fir_fm_exact`` runs its plain
PyTorch version; the CUDA kernel is held to that version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.ops.pallas_fir_mxu import _atan2_poly
from libsdr_tpu.ops.pallas_fir_mxu import fir_fm_exact as jax_fir_fm_exact
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops.fir_fm import atan2_poly, fir_fm_exact

C, B, N_BLOCKS = 64, 4096, 3
ROT, GAIN, AB = np.exp(-0.41j), 1.3, (0.95, 0.05)


def _planes(x, dtype):
    """numpy complex -> (JAX Complex, torch Complex) with identical planes
    of ``dtype`` (bf16 rounds once, in JAX; torch gets the same values)."""
    jx = jcplx.Complex(jnp.asarray(x.real, jnp.float32).astype(dtype),
                       jnp.asarray(x.imag, jnp.float32).astype(dtype))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx = Complex(
        torch.from_numpy(np.array(jx.re.astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.array(jx.im.astype(jnp.float32))).to(tdt))
    return jx, tx


def _stream_oracle(xq, g, d, t, deemph, channels):
    """Per-window numpy oracle over the whole stream (zero history), as in
    tests/test_pallas.py::test_pallas_exact_tiling_fm_kernel."""
    xc = np.concatenate([np.zeros((len(channels), t - 1), np.complex128),
                         xq[list(channels)].astype(np.complex128)], axis=-1)
    n_out = xq.shape[-1] // d
    win = np.lib.stride_tricks.sliding_window_view(xc, t, axis=-1)
    y = win[:, d - 1::d][:, :n_out] @ g          # window ends at (j+1)D-1
    yp = np.concatenate([np.ones((len(channels), 1)), y[:, :-1]], axis=-1)
    au = GAIN * np.angle(y * np.conj(yp) * ROT)
    if not deemph:
        return au
    out = np.empty_like(au)
    st = np.zeros(len(channels))
    for j in range(n_out):
        st = AB[0] * st + AB[1] * au[:, j]
        out[:, j] = st
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deemph", [True, False])
@pytest.mark.parametrize("D,T", [(2, 37), (2, 67), (4, 37), (4, 67)])
def test_fir_fm_exact_matches_jax_kernel(D, T, deemph, dtype):
    rng = np.random.default_rng(1000 * D + T)
    x = (rng.normal(size=(C, N_BLOCKS * B))
         + 1j * rng.normal(size=(C, N_BLOCKS * B))).astype(np.complex64)
    g = rng.normal(size=T) + 1j * rng.normal(size=T)
    jx_all, tx_all = _planes(x, dtype)
    taps = Complex(torch.tensor(g.real, dtype=torch.float32),
                   torch.tensor(g.imag, dtype=torch.float32))
    ab = AB if deemph else None

    j_tail = jcplx.Complex(jnp.zeros((C, T - 1), jx_all.re.dtype),
                           jnp.zeros((C, T - 1), jx_all.re.dtype))
    j_prev = jcplx.as_block(np.ones((C, 1), np.complex64))
    j_d = jnp.zeros((C, 1), jnp.float32)
    t_tail = Complex(torch.zeros((C, T - 1), dtype=tx_all.re.dtype),
                     torch.zeros((C, T - 1), dtype=tx_all.re.dtype))
    t_prev = Complex(torch.ones(C), torch.zeros(C))
    t_d = torch.zeros(C)
    got_j, got_t = [], []
    for k in range(N_BLOCKS):
        sl = slice(k * B, (k + 1) * B)
        jx, tx = jx_all[:, sl], tx_all[:, sl]
        audio, j_last = jax_fir_fm_exact(jx, g, D, j_tail, j_prev, ROT, GAIN,
                                         deemph_ab=ab,
                                         deemph_lead=j_d if deemph else None,
                                         interpret=True)
        out, t_last = fir_fm_exact(tx, taps, D, t_tail, t_prev, ROT, GAIN,
                                   deemph_ab=ab, dstate=t_d if deemph else None)
        assert out.shape == (C, B // D) and out.dtype == torch.float32
        got_j.append(np.asarray(audio))
        got_t.append(out.numpy())
        np.testing.assert_allclose(t_last.re.numpy(),
                                   np.asarray(j_last.re)[:, 0],
                                   rtol=1e-4, atol=1e-4)
        j_tail, j_prev = jx[..., B - (T - 1):], j_last
        t_tail, t_prev = tx[..., B - (T - 1):], t_last
        if deemph:
            j_d, t_d = audio[..., -1:], out[..., -1]
    got_j = np.concatenate(got_j, -1)
    got_t = np.concatenate(got_t, -1)

    # vs the JAX kernel: the tolerance of tests/test_pallas.py:271-272 (the
    # angle is ill-conditioned where |y| is tiny in noise input)
    err = np.abs(got_t - got_j)
    assert np.median(err) < 1e-4
    assert np.percentile(err, 99.5) < 5e-3

    # vs the per-window oracle on the planes both sides read
    xq = tx_all.re.float().numpy() + 1j * tx_all.im.float().numpy()
    chans = (0, 5)
    orc = _stream_oracle(xq, g, D, T, deemph, chans)
    n_b = B // D
    for j in list(range(3 * 128 + 5)) + [n_b - 1, n_b, 2 * n_b - 1, 2 * n_b]:
        for i, c in enumerate(chans):
            assert abs(got_t[c, j] - orc[i, j]) < 5e-3 * max(1.0,
                                                             abs(orc[i, j]))


def test_atan2_poly_matches_jax():
    rng = np.random.default_rng(7)
    y = rng.normal(size=4096).astype(np.float32)
    x = rng.normal(size=4096).astype(np.float32)
    y[:4], x[:4] = [0, 1, -1, 0], [1, 0, 0, -1]
    got = atan2_poly(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ref = np.asarray(_atan2_poly(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.abs(got - np.arctan2(y, x)).max() < 2e-5
