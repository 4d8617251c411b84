"""Pipelines of processors (counterpart of ``libsdr_tpu.core.graph``).

A :class:`Pipeline` is an ordered chain of processors; :meth:`bind` runs the
spec propagation pass, with the fusion rewrite of ``core/fuse.py`` first,
and :meth:`compile` returns the step

    step(carry, block) -> (carry, out_block)

PyTorch runs eagerly, so the step is :meth:`apply` itself.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

from libsdr_tpu_torch.core.block import Carry, Processor
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec


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

    def init_carry(self, device=None) -> Carry:
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
