"""FM at stride D = 1 on a fading signal against its function in float64:
the port's plain version (what a CPU block runs) and the JAX package's D = 1
path, which is XLA's (its kernel gate wants a stride above 1), stage by
stage (the FIR y, the discriminator's audio, the de-emphasized output),
on the same inputs and carries (``libsdr_tpu_torch/tools/fm_accuracy.py``,
whose card run holds the kernel the same way).

Each version is held against its own function in float64: the port's
discriminator is the kernels' atan2 polynomial, JAX's off-kernel one the
angle.  The port is a fault only where it is farther from float64 than
the reference is; ``-s`` prints both.
"""

import jax.numpy as jnp
import numpy as np
import torch

import libsdr_tpu as J
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops import fir_fm as F
from libsdr_tpu_torch.tools import fm_accuracy as FA


def _jax_stages(c):
    """The JAX package's chain at D = 1 on the CPU: unfused (its fusion
    pass fuses on a TPU only), IQBaseBand's NCO folded into its FIR taps
    and FMDemod's rotation, the taps the port's fused op takes."""
    from libsdr_tpu.ops import FMDeemph, FMDemod, IQBaseBand

    rx = J.Pipeline([IQBaseBand(fc=FA.FS / 8, width=FA.FS / 4.8,
                                order=FA.N_TAPS, decim=1, design="textbook"),
                     FMDemod(), FMDeemph()])
    rx.bind(J.StreamSpec(np.complex64, FA.FS, FA.BLOCK, channels=(c,)))
    assert rx.stages[0].fold_nco
    return rx.stages


def _j(v):
    if isinstance(v, Complex):
        return jcplx.Complex(jnp.asarray(v.re.numpy()),
                             jnp.asarray(v.im.numpy()))
    return jnp.asarray(v.numpy())


def _t(v):
    if isinstance(v, jcplx.Complex):
        return Complex(torch.from_numpy(np.array(v.re)),
                       torch.from_numpy(np.array(v.im)))
    return torch.from_numpy(np.array(v))


def test_fm_d1_port_no_farther_from_float64_than_jax():
    """Blocks 1-3 of the fading signal (a warm block first), every stage:
    the port's plain version within 1.5x of the JAX package's error against
    float64 (max and 99.9th percentile, relative to each channel's largest
    value), and within the card tests' FM bound, 1e-4, on 4 channels."""
    c = 4
    op = FA.fm_op(c)
    bb, dm, de = _jax_stages(c)
    taps = op._taps("cpu")
    np.testing.assert_array_equal(
        np.asarray(bb._inner.stages[0].taps).astype(np.complex64),
        taps.re.numpy() + 1j * taps.im.numpy())
    worst = {}
    for a in FA.block_inputs(op, c, "cpu")[1:]:
        x, taps, _, tail, prev, rot, gain, dab, dstate = a
        ports = {
            "y": F.fir_exact_plain(x, taps, 1, tail),
            "audio": F.fir_fm_exact_plain(*a[:7])[0],
            "out": F.fir_fm_exact_plain(*a)[0],
        }
        _, jy = bb.apply((_j(tail),), _j(x))
        _, jaudio = dm.apply(_j(prev), jy)
        _, jout = de.apply(_j(dstate), jaudio)
        jaxs = {"y": _t(jy), "audio": _t(jaudio), "out": _t(jout)}
        f64 = {angle: dict(zip(("y", "audio", "out"), FA.exact_f64(
            x, taps, tail, prev, rot, gain, dab, dstate, angle=angle)))
            for angle in ("poly", "exact")}
        for name in ports:
            for who, got, angle in (("port", ports[name], "poly"),
                                    ("jax", jaxs[name], "exact")):
                e = FA.rel_errors(got, f64[angle][name])
                w = worst.setdefault(name, {}).setdefault(
                    who, dict(max=0.0, p999=0.0))
                for m in w:
                    w[m] = max(w[m], e[m])
    print(f"D = 1, {c} ch, relative to float64: {worst}")
    for name, w in worst.items():
        for m in ("max", "p999"):
            assert w["port"][m] <= 1.5 * w["jax"][m], (name, m, w)
        assert w["port"]["max"] < 1e-4, (name, w)
