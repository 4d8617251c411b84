"""First-order IIR filtering (counterpart of ``libsdr_tpu.ops.iir``).

``y[n] = a*y[n-1] + b*x[n]`` with a constant scalar ``a`` is solved per
frame of S samples in closed form with one matmul against the
lower-triangular impulse response L[m, s] = a^(s-m):

    p[f, :] = (b*x)[f, :] @ L             (one pass over the data)
    Y[f]    = a^S * Y[f-1] + p[f, S-1]    (the same recurrence, B/S long)
    y[f, s] = p[f, s] + a^(s+1) * Y[f-1]  (elementwise fix-up)

The frame-end recurrence is the same problem S times shorter, so it recurses
until one frame is left; no Python loop runs over samples.

With per-sample coefficients (:func:`iir_first_order_varcoef`) the
recurrence is associative under

    (a2, b2) o (a1, b1) = (a1*a2, a2*b1 + b2)

and runs as a scan by doubling steps: log2(B) passes of elementwise ops on
the caller's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_FRAME = 128


def iir_first_order(x: torch.Tensor, a: float, b: float,
                    y0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``y[n] = a*y[n-1] + b*x[n]`` along the trailing axis.

    Args:
      x: (..., B) input block.
      a, b: scalar coefficients.
      y0: (...,) initial state ``y[-1]`` (tensor or scalar).

    Returns:
      (y, y_last): the output block and the final state.
    """
    s = _FRAME
    n = x.shape[-1]
    lead = x.shape[:-1]
    a = float(a)
    nf = -(-n // s)
    # Zeros appended after the end leave every earlier output unchanged.
    bx = F.pad(float(b) * x, (0, nf * s - n)).reshape(lead + (nf, s))
    e = np.arange(s)[None, :] - np.arange(s)[:, None]
    lmat = np.where(e >= 0, np.power(a, np.maximum(e, 0)), 0.0)
    p = torch.matmul(bx, torch.as_tensor(lmat, dtype=x.dtype,
                                         device=x.device))
    y0 = torch.as_tensor(y0, dtype=x.dtype, device=x.device
                         ).expand(lead)[..., None]
    if nf > 1:
        ends, _ = iir_first_order(p[..., :-1, s - 1], a ** s, 1.0, y0[..., 0])
        y0 = torch.cat([y0, ends], dim=-1)
    apow = torch.as_tensor(np.power(a, np.arange(1, s + 1)), dtype=x.dtype,
                           device=x.device)
    y = (p + y0[..., None] * apow).reshape(lead + (nf * s,))[..., :n]
    return y, y[..., -1]


def iir_first_order_varcoef(x: torch.Tensor, a, b,
                            y0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``y[n] = a[n]*y[n-1] + b[n]*x[n]`` along the trailing axis, with
    per-sample coefficients (the AGC's signal-dependent decay).

    Args:
      x: (..., B) input block.
      a, b: per-sample coefficients, broadcastable to x.
      y0: (...,) initial state ``y[-1]`` (tensor or scalar); ``a[..., 0]
        * y0`` folds into the first input.

    Returns:
      (y, y_last): the output block and the final state, on x's device.
    """
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device).expand(x.shape)
    bx = torch.as_tensor(b, dtype=x.dtype, device=x.device) * x
    y0 = torch.as_tensor(y0, dtype=x.dtype, device=x.device)
    bx = torch.cat([bx[..., :1] + (a[..., 0] * y0)[..., None], bx[..., 1:]],
                   dim=-1)
    a = torch.cat([torch.ones_like(a[..., :1]), a[..., 1:]], dim=-1)
    n = x.shape[-1]
    shift = 1
    while shift < n:
        # compose each element with the one `shift` before it (the first
        # `shift` have none: the identity (1, 0))
        bx = torch.cat([bx[..., :shift],
                        a[..., shift:] * bx[..., :-shift] + bx[..., shift:]],
                       dim=-1)
        a = torch.cat([a[..., :shift], a[..., shift:] * a[..., :-shift]],
                      dim=-1)
        shift *= 2
    return bx, bx[..., -1]
