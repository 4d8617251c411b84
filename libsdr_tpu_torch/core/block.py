"""Processor protocol (counterpart of ``libsdr_tpu.core.block``).

A processor has three responsibilities:

1. :meth:`Processor.bind` validates the input :class:`StreamSpec`, derives
   its constants (numpy, on the host) and returns the output spec;
2. :meth:`Processor.init_carry` returns the explicit state (tensors, Complex
   planes or tuples of them) on the device it is asked for, the card when
   it is not asked (``core/graph.py::resolve_device``); a stage builds it
   in :meth:`Processor._init_carry`;
3. :meth:`Processor.apply` maps ``(carry, x) -> (carry, y)``, on the device
   of the input block ``x``.

All processors treat the trailing axis as time and broadcast over leading
channel axes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec

Carry = Any


class Processor:
    """Base class for all stream processors."""

    def __init__(self) -> None:
        self._in_spec: Optional[StreamSpec] = None
        self._out_spec: Optional[StreamSpec] = None

    def bind(self, in_spec: StreamSpec) -> StreamSpec:
        out = self._bind(in_spec)
        self._in_spec = in_spec
        self._out_spec = out
        return out

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        """Validate ``in_spec`` and return the output spec (default: pass
        through)."""
        return in_spec

    @property
    def is_bound(self) -> bool:
        return self._out_spec is not None

    @property
    def in_spec(self) -> StreamSpec:
        if self._in_spec is None:
            raise ConfigError(f"{type(self).__name__} is not bound yet")
        return self._in_spec

    @property
    def out_spec(self) -> StreamSpec:
        if self._out_spec is None:
            raise ConfigError(f"{type(self).__name__} is not bound yet")
        return self._out_spec

    def init_carry(self, device=None) -> Carry:
        """Initial state on ``device`` (default: the card; without one
        :class:`RuntimeSDRError`, and ``device="cpu"`` asks for the CPU)."""
        from libsdr_tpu_torch.core.graph import resolve_device
        return self._init_carry(resolve_device(device))

    def _init_carry(self, device) -> Carry:
        """Initial state on the torch device ``device``.  Default:
        stateless."""
        return ()

    def apply(self, carry: Carry, x) -> Tuple[Carry, Any]:
        raise NotImplementedError

    def __repr__(self) -> str:
        s = f"<{type(self).__name__}"
        if self._out_spec is not None:
            s += f" -> {self._out_spec}"
        return s + ">"


class Proxy(Processor):
    """Pass-through stage."""

    def apply(self, carry, x):
        return carry, x


class Lambda(Processor):
    """A stateless function of the block as a stage (the plumbing stages'
    shape: scale, cast, real part).

    Args:
      fn: block -> block, on tensors or on Complex values, keeping the time
        axis's length unless ``spec_fn`` says otherwise.
      spec_fn: optional ``in_spec -> out_spec``; default passthrough.
      name: shown in the stage's repr.
    """

    def __init__(self, fn: Callable, spec_fn: Optional[Callable] = None,
                 name: str = "Lambda"):
        super().__init__()
        self._fn = fn
        self._spec_fn = spec_fn
        self._name = name

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        return self._spec_fn(in_spec) if self._spec_fn else in_spec

    def apply(self, carry, x):
        return carry, self._fn(x)

    def __repr__(self) -> str:
        return f"<Lambda:{self._name}>"
