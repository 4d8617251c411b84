"""The channelizer outside K4's gate (M > 8192 or P > 32), on the CPU:
the route predicate of ``parallel/wideband.py::channelize_local`` and
``ops/wideband_rx.py::wideband_fm_local``, and ``Channelizer(16384, 8)``
and ``Channelizer(64, 40)`` over three carried blocks against the JAX
package's ``Channelizer``, which runs its XLA body at those shapes, within
2e-5 of the largest |Y| (tests/test_torch_wideband.py's channelizer bound).
On a card the same shapes run ``channelize_segment`` with no K4 launch
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import libsdr_tpu as J
import libsdr_tpu_torch as P
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.ops import pfb
from libsdr_tpu_torch.ops.wideband_rx import fm_local_kernel_ok
from libsdr_tpu_torch.parallel.wideband import channelize_kernel_ok

REL = 2e-5


def test_route_predicate_is_k4s_gate():
    """On a card the kernel takes a segment exactly where pfb_supported
    holds (M <= 8192, P <= 32, float32 or bfloat16 planes); a CPU
    segment never launches it.  The shape alone decides."""
    for m, p, want in ((8192, 8, True), (8193, 8, False), (16384, 8, False),
                       (64, 32, True), (64, 33, False), (64, 40, False)):
        x = cplx.zeros((m * 4,))
        assert not channelize_kernel_ok(x, m, p)
        assert not fm_local_kernel_ok(x, m, p)
        assert pfb.pfb_supported(m, 4, p, torch.float32) == want
        assert pfb.pfb_supported(m, 4, p, torch.bfloat16) == want
    assert not pfb.pfb_supported(64, 4, 8, torch.float16)


@pytest.mark.parametrize("m,p,frames", [(16384, 8, 12), (64, 40, 48),
                                        (64, 40, 20)])
def test_channelizer_outside_gate_matches_jax(m, p, frames):
    """Three carried blocks (the third config's blocks hold fewer frames
    than P) against JAX's Channelizer, within 2e-5 of max |Y|."""
    from libsdr_tpu.ops import Channelizer as JChannelizer
    from libsdr_tpu_torch.ops import Channelizer

    import jax.numpy as jnp

    block = m * frames
    jop, pop = JChannelizer(m, p), Channelizer(m, p)
    jop.bind(J.StreamSpec(np.complex64, 1e6, block))
    pop.bind(P.StreamSpec(np.complex64, 1e6, block))
    rng = np.random.default_rng(m + p + frames)
    jc, pc = jop.init_carry(), pop.init_carry("cpu")
    for _ in range(3):
        x = (rng.normal(size=block) + 1j * rng.normal(size=block)).astype(
            np.complex64)
        jc, jy = jop.apply(jc, jcplx.Complex(jnp.asarray(x.real),
                                             jnp.asarray(x.imag)))
        pc, py = pop.apply(pc, cplx.as_block(x, device="cpu"))
        got, ref = cplx.to_numpy(py), jcplx.to_numpy(jy)
        assert got.shape == ref.shape == (m, frames)
        assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
