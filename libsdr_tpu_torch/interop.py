"""Carry states across between the JAX package and this one.

A carry is a nest of tuples and dicts (the BitStream's carry is a dict)
whose leaves are arrays or planar complex values.  :func:`state_from_numpy` takes any such nest whose leaves are
array-likes or objects with ``.re``/``.im`` (a JAX ``Complex`` among them,
without importing JAX) and returns this package's carry on a device (the
card unless asked for another, as ``Pipeline.init_carry``);
:func:`state_to_numpy` returns numpy leaves, with planar values as
:class:`PlanarArray`.  numpy has no bfloat16, so bfloat16 planes come back
widened (exactly) to float32.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex, _host
from libsdr_tpu_torch.core.graph import resolve_device


class PlanarArray:
    """A planar complex value on the host: two numpy planes."""

    __slots__ = ("re", "im")

    def __init__(self, re: np.ndarray, im: np.ndarray):
        self.re = re
        self.im = im


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX gives it
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_numpy(tree, device=None):
    """A carry nest of host arrays (or JAX arrays) as tensors on ``device``
    (default: the card, see ``core/graph.py::resolve_device``)."""
    device = resolve_device(device)
    if hasattr(tree, "re") and hasattr(tree, "im"):
        return Complex(_tensor(tree.re, device), _tensor(tree.im, device))
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_from_numpy(t, device) for t in tree)
    return _tensor(tree, device)


def state_to_numpy(tree):
    """A carry nest of tensors as numpy, planar values as PlanarArray."""
    if isinstance(tree, Complex):
        return PlanarArray(_host(tree.re), _host(tree.im))
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_to_numpy(t) for t in tree)
    return _host(tree)
