"""libsdr_tpu_torch — the PyTorch/CUDA port of libsdr_tpu.

A radio pipeline is a function over fixed-size time blocks::

    step(carry, block) -> (carry, out_block)

with all per-stage state held in an explicit ``carry`` of tensors.  Complex
streams are planar (:mod:`libsdr_tpu_torch.core.cplx`), and channel banks
are the leading tensor axes.  The hot path, the fused FIR + FM +
de-emphasis receive chain, runs in a hand-written CUDA kernel
(``csrc/fir_fm_exact.cu``) built with nvcc at first use; on CPU tensors
every op takes its plain PyTorch version.  The package never imports JAX;
``libsdr_tpu`` stays the reference it is tested against.

- :mod:`libsdr_tpu_torch.core` — stream specs, processors, pipelines and
  fusion, the host streaming loop.
- :mod:`libsdr_tpu_torch.ops` — FIR, IIR, NCO, baseband selection, FM
  demodulation and the fused FM front end.
- :mod:`libsdr_tpu_torch.interop` — carries to and from the JAX package.
"""

__version__ = "0.1.0"

from libsdr_tpu_torch.core.stream import StreamSpec  # noqa: F401
from libsdr_tpu_torch.core.block import Processor  # noqa: F401
from libsdr_tpu_torch.core.graph import Pipeline  # noqa: F401
