"""Pipelines of processors (counterpart of ``libsdr_tpu.core.graph``).

A :class:`Pipeline` is an ordered chain of processors; :meth:`bind` runs the
spec propagation pass, with the fusion rewrite of ``core/fuse.py`` first,
and :meth:`compile` returns the step

    step(carry, block) -> (carry, out_block)

PyTorch runs eagerly, so the step is :meth:`apply` itself.
:meth:`switch_stages` restructures a bound pipeline mid-stream (the rx
app's live mode switch) and carries the state of the unchanged front over.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from libsdr_tpu_torch.core.block import Carry, Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import (ConfigError, RuntimeSDRError,
                                          StreamSpec)


def resolve_device(device=None) -> torch.device:
    """The torch device of a library entry point: ``device``, or the card
    (``"cuda"``) when it is None.  A CUDA device that is not there raises
    :class:`RuntimeSDRError`: nothing falls back to the CPU, which a caller
    asks for with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeSDRError(
            f"device {dev}: no CUDA device is available (pass "
            "device='cpu' for the plain PyTorch versions)")
    return dev


class Pipeline(Processor):
    """Sequential composition of processors (itself a Processor)."""

    def __init__(self, stages: Sequence[Processor], name: str = "Pipeline",
                 optimize: bool = True):
        super().__init__()
        self.stages: List[Processor] = list(stages)
        self.name = name
        self.optimize = optimize

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        from libsdr_tpu_torch.core.fuse import fuse_stages, reset_fusion_state

        orig = list(self.stages)
        if self.optimize:
            self.stages = fuse_stages(orig)
        try:
            return self._bind_stages(self.stages, in_spec)
        except ConfigError:
            # A fused op may refuse a spec that the unfused stages take: the
            # fused ops are optimizations, never capability changes, so
            # restore the original stages and bind them unfused.
            if (len(self.stages) == len(orig)
                    and all(a is b for a, b in zip(self.stages, orig))):
                raise
            # fuse_stages wrote state onto the original instances (folded
            # rotations); clear it, or the restored stages apply it twice.
            reset_fusion_state(orig)
            self.stages = orig
            return self._bind_stages(orig, in_spec)

    @staticmethod
    def _bind_stages(stages, spec: StreamSpec) -> StreamSpec:
        for stage in stages:
            spec = stage.bind(spec)
        return spec

    def _init_carry(self, device) -> Carry:
        """Every stage's initial state on ``device``."""
        return tuple(stage.init_carry(device) for stage in self.stages)

    def apply(self, carry: Carry, x) -> Tuple[Carry, Any]:
        new_carries = []
        for stage, c in zip(self.stages, carry):
            c, x = stage.apply(c, x)
            new_carries.append(c)
        return tuple(new_carries), x

    def compile(self):
        """The step ``(carry, x) -> (carry, y)``: the eager :meth:`apply`
        (the JAX package jits here; PyTorch needs no trace)."""
        return self.apply

    def switch_stages(self, new_stages: Sequence[Processor], old_carry):
        """Replace the stages of a bound pipeline mid-stream.

        Re-runs fusion and spec propagation with the same input spec and
        returns the carry for the new structure, with the state of every
        leading piece whose structure did not change transplanted from
        ``old_carry`` (switching WFM -> AM keeps the front-end FIR tail
        warm; only the demodulator's state starts fresh).  Call
        :meth:`compile` again afterwards.
        """
        if not self.is_bound:
            raise RuntimeError("switch_stages: pipeline is not bound")
        self.stages = list(new_stages)
        self.bind(self.in_spec)
        device = _device_of(old_carry)
        return _transplant_carry(tuple(old_carry), self.init_carry(device))

    def describe(self) -> str:
        """One line per bound stage: its type and output spec."""
        lines = [f"{self.name}:"]
        for stage in self.stages:
            out = str(stage.out_spec) if stage.is_bound else "(unbound)"
            lines.append(f"  {type(stage).__name__:<24} -> {out}")
        return "\n".join(lines)


def _leaves(tree):
    """Leaves of a carry nest (tensors; Complex as its two planes) and its
    structure, the analog of a pytree flatten."""
    if isinstance(tree, Complex):
        return [tree.re, tree.im], "C"
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_leaves(tree[k]) for k in keys]
        return ([x for p in parts for x in p[0]],
                ("dict", tuple(keys), tuple(p[1] for p in parts)))
    if isinstance(tree, (tuple, list)):
        parts = [_leaves(t) for t in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree).__name__, tuple(p[1] for p in parts)))
    return [tree], "L"


def _device_of(tree):
    leaves, _ = _leaves(tree)
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _transplant_carry(old, fresh):
    """Transplant state from ``old`` into the structure of ``fresh``: where
    a sub-tree of the new carry matches the old one (same structure, leaf
    shapes and dtypes), the old values carry over; mismatched sub-trees (new
    or reconfigured stages) keep their fresh initial state.  Tuples of
    different length transplant their common prefix."""
    la, ta = _leaves(old)
    lb, tb = _leaves(fresh)
    if ta == tb and all(
            getattr(x, "shape", None) == getattr(y, "shape", None)
            and getattr(x, "dtype", None) == getattr(y, "dtype", None)
            for x, y in zip(la, lb)):
        return old
    if isinstance(old, (tuple, list)) and isinstance(fresh, (tuple, list)):
        return type(fresh)(
            _transplant_carry(old[i], f) if i < len(old) else f
            for i, f in enumerate(fresh))
    return fresh
