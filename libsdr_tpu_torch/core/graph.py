"""Pipelines of processors (counterpart of ``libsdr_tpu.core.graph``).

A :class:`Pipeline` is an ordered chain of processors; :meth:`bind` runs the
spec propagation pass, with the fusion rewrite of ``core/fuse.py`` first,
and :meth:`compile` returns the step

    step(carry, block) -> (carry, out_block)

PyTorch runs eagerly, so the step is :meth:`apply` itself.
:meth:`compile_chunked` returns a step over K blocks: on the card the K
steps captured once into a CUDA graph and replayed (one dispatch for K
blocks), on the CPU a loop over :meth:`apply`.  :meth:`switch_stages`
restructures a bound pipeline mid-stream (the rx app's live mode switch)
and carries the state of the unchanged front over.  :class:`Tee` feeds one
block to several branches and :class:`Combine` stacks their outputs on a
new channel axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from libsdr_tpu_torch.core.block import Carry, Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.ragged import Ragged
from libsdr_tpu_torch.core.stream import (ConfigError, RuntimeSDRError,
                                          StreamSpec)
from libsdr_tpu_torch.utils.profiling import span


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
        self._chunked: Dict[str, "ChunkedStep"] = {}

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        from libsdr_tpu_torch.core.fuse import fuse_stages, reset_fusion_state

        # A (re)bind recomputes taps and fusion: graphs captured before it
        # replay the old stages.
        self._chunked = {}
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
        with span("pipeline"):
            for stage, c in zip(self.stages, carry):
                with span("stage:" + type(stage).__name__):
                    c, x = stage.apply(c, x)
                new_carries.append(c)
        return tuple(new_carries), x

    def compile(self):
        """The step ``(carry, x) -> (carry, y)``: the eager :meth:`apply`
        (the JAX package jits here; PyTorch needs no trace)."""
        return self.apply

    def compile_chunked(self, mode: str = "unroll") -> "ChunkedStep":
        """The step ``(carry, xs) -> (carry, ys)`` over K blocks, equal bit
        for bit to K :meth:`compile` steps.

        ``"unroll"``: ``xs`` and ``ys`` are length-K tuples of blocks.
        ``"scan"``: K-stacked tensors (or Complex), leading axis K.

        On the card the K steps are captured once into a CUDA graph, keyed
        by K and the blocks' shapes, dtypes and device, and replayed: one
        dispatch processes K blocks, and the kernels' launch counts move
        during the capture only (:meth:`ChunkedStep.graph_launches` gives
        launches per capture times replays).  Blocks on the card are read
        where they lie by a graph keyed also by their addresses (up to
        ``IN_PLACE_GRAPHS`` of them a shape, so a ring of input buffers
        replays without copies); other blocks are copied into the graph's
        own inputs.  Each graph keeps its own outputs (K blocks' worth), so
        a block shape may hold ``IN_PLACE_GRAPHS + 1`` of them.  A step
        that reads the host
        cannot be captured: the call raises :class:`ConfigError` naming the
        pipeline, and nothing runs eagerly in its place.  On the CPU both
        modes loop over :meth:`apply`.
        """
        if mode not in ("unroll", "scan"):
            raise ValueError(f"compile_chunked: unknown mode {mode!r}")
        if mode not in self._chunked:
            self._chunked[mode] = ChunkedStep(self, mode)
        return self._chunked[mode]

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
    """Leaves of a carry or block nest (tensors; Complex and Ragged as
    their two planes) and its structure, the analog of a pytree flatten."""
    if isinstance(tree, Complex):
        return [tree.re, tree.im], "C"
    if isinstance(tree, Ragged):
        return [tree.data, tree.valid], "R"
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


def _rebuild(struct, leaves):
    """The nest of structure ``struct`` (from :func:`_leaves`) over an
    iterator of its leaves."""
    if struct == "C":
        return Complex(next(leaves), next(leaves))
    if struct == "R":
        return Ragged(next(leaves), next(leaves))
    if struct == "L":
        return next(leaves)
    if struct[0] == "dict":
        return {k: _rebuild(t, leaves) for k, t in zip(struct[1], struct[2])}
    parts = [_rebuild(t, leaves) for t in struct[1]]
    return tuple(parts) if struct[0] == "tuple" else parts


def _stack(blocks):
    """K blocks of one structure stacked leaf by leaf on a new axis 0."""
    parts = [_leaves(b) for b in blocks]
    cols = zip(*(p[0] for p in parts))
    return _rebuild(parts[0][1], iter([torch.stack(c) for c in cols]))


def _unstack(xs):
    """The K blocks of a K-stacked block (leading axis K)."""
    leaves, struct = _leaves(xs)
    k = leaves[0].shape[0]
    return tuple(_rebuild(struct, iter([v[i] for v in leaves]))
                 for i in range(k))


def _k_steps(pipeline: "Pipeline", carry, xs):
    """``pipeline.apply`` over the blocks ``xs`` in turn: (carry, ys)."""
    ys = []
    for x in xs:
        carry, y = pipeline.apply(carry, x)
        ys.append(y)
    return carry, tuple(ys)


def kernel_entries():
    """The port's kernel wrappers that count their launches (``launches``
    and, by route or layout, ``routes``)."""
    from libsdr_tpu_torch.ops.fir_fm import (fir_afsk_exact, fir_am_exact,
                                             fir_exact, fir_fm_exact,
                                             fir_usb_exact)
    from libsdr_tpu_torch.ops.fir_mxu import fir_fm_mxu, fir_mxu
    from libsdr_tpu_torch.ops.fixedpoint import deemph_int
    from libsdr_tpu_torch.ops.pfb import pfb_mxu
    from libsdr_tpu_torch.ops.pll import pll, pll_bank, window_pack
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan
    return (fir_fm_exact, fir_exact, fir_am_exact, fir_usb_exact,
            fir_afsk_exact, fir_mxu, fir_fm_mxu, pfb_mxu, pll, pll_bank,
            bpsk31_scan, deemph_int, window_pack)


def _counts():
    return {e: (e.launches, dict(getattr(e, "routes", {})))
            for e in kernel_entries()}


def _restore_counts(saved) -> None:
    for e, (n, routes) in saved.items():
        e.launches = n
        if routes:
            e.routes = routes


# Graphs a block shape may capture that read the blocks where they lie on
# the card (keyed by their addresses: a ring of input buffers replays
# without copies); past them one graph copies each chunk into its inputs.
IN_PLACE_GRAPHS = 8


class _GraphChunk:
    """K steps of a pipeline captured into one CUDA graph: static input
    tensors for the carry, copied in before each replay, and for the blocks
    (or, ``in_place``, the blocks' own addresses); the graph's outputs are
    overwritten by the next replay."""

    def __init__(self, pipeline: "Pipeline", carry, xs, dev,
                 in_place: bool = False):
        self.pipeline = pipeline
        c_leaves, self.c_struct = _leaves(carry)
        x_leaves, self.x_struct = _leaves(tuple(xs))
        name = pipeline.name
        for v in c_leaves + x_leaves:
            if not isinstance(v, torch.Tensor):
                raise ConfigError(
                    f"{name}: compile_chunked: a carry or block holds the "
                    f"host value {v!r}, which a CUDA graph cannot update")
        self.c_in = [v.to(dev, copy=True) for v in c_leaves]
        self.in_place = in_place
        self.x_in = (list(x_leaves) if in_place
                     else [v.to(dev, copy=True) for v in x_leaves])
        # Warm-up on a side stream (first-use caches, the library's build),
        # its launches not counted: they are not the path's.
        saved = _counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._steps()
        torch.cuda.current_stream(dev).wait_stream(side)
        _restore_counts(saved)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                out = self._steps()
        except RuntimeError as e:
            raise ConfigError(
                f"{name}: compile_chunked: its step cannot be captured into "
                f"a CUDA graph (a step that reads the host cannot): "
                f"{e}") from e
        now = _counts()
        # launches per capture, by entry
        self.launches = {e.__name__: now[e][0] - saved[e][0]
                         for e in now if now[e][0] != saved[e][0]}
        self.out, self.o_struct = _leaves(out)
        for v in self.out:
            if not isinstance(v, torch.Tensor):
                raise ConfigError(
                    f"{name}: compile_chunked: the step returns the host "
                    f"value {v!r}, which a CUDA graph cannot update")
        if in_place:
            self.x_in = None    # the key holds the blocks' addresses
        self.replays = 0

    def _steps(self):
        return _k_steps(self.pipeline,
                        _rebuild(self.c_struct, iter(self.c_in)),
                        _rebuild(self.x_struct, iter(self.x_in)))

    def __call__(self, carry, xs, clone: bool = True):
        with span("chunked.copy_in"):
            for s, v in zip(self.c_in, _leaves(carry)[0]):
                s.copy_(v)
            if not self.in_place:   # blocks on the host go straight in
                for s, v in zip(self.x_in, _leaves(tuple(xs))[0]):
                    s.copy_(v)
        with span("chunked.replay"):
            self.graph.replay()
        self.replays += 1
        out = [v.clone() for v in self.out] if clone else list(self.out)
        return _rebuild(self.o_struct, iter(out))


class ChunkedStep:
    """The step of :meth:`Pipeline.compile_chunked` in one mode."""

    def __init__(self, pipeline: Pipeline, mode: str):
        self.pipeline = pipeline
        self.mode = mode
        self.graphs: Dict[tuple, _GraphChunk] = {}

    def __call__(self, carry, xs):
        if self.mode == "scan":
            carry, ys = self.run(carry, _unstack(xs))
            return carry, _stack(ys)
        return self.run(carry, tuple(xs))

    def run(self, carry, xs: tuple, clone: bool = True, device=None):
        """K blocks (a tuple) through K steps on ``device`` (default: the
        blocks'; host blocks for the card are copied into the graph's
        inputs).  ``clone=False`` returns the graph's own output tensors,
        valid until its next replay."""
        with span("chunked.run"):
            return self._run(carry, xs, clone, device)

    def _run(self, carry, xs: tuple, clone: bool, device):
        leaves, _ = _leaves(xs)
        dev = leaves[0].device if device is None else torch.device(device)
        if dev.type != "cuda":
            return _k_steps(self.pipeline, carry, xs)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (len(xs), dev, tuple((tuple(v.shape), v.dtype, v.stride())
                                   for v in leaves))
        graph = None
        if all(v.device == dev for v in leaves):
            at = key + (tuple(v.data_ptr() for v in leaves),)
            graph = self.graphs.get(at)
            if graph is None and sum(
                    len(k) == 4 and k[:3] == key
                    for k in self.graphs) < IN_PLACE_GRAPHS:
                with span("chunked.capture"):
                    graph = self.graphs[at] = _GraphChunk(
                        self.pipeline, carry, xs, dev, in_place=True)
        if graph is None:
            graph = self.graphs.get(key)
        if graph is None:
            with span("chunked.capture"):
                graph = self.graphs[key] = _GraphChunk(self.pipeline, carry,
                                                       xs, dev)
        return graph(carry, xs, clone)

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by this step's replays: each graph's
        launches per capture times its replays, by entry name."""
        total: Dict[str, int] = {}
        for g in self.graphs.values():
            for name, n in g.launches.items():
                total[name] = total.get(name, 0) + n * g.replays
        return total


class Combine(Processor):
    """N-input join: equal-spec branch outputs (a :class:`Tee`'s) stacked
    on a new leading channel axis with ``torch.stack``, both planes of a
    Complex."""

    def __init__(self, n: int):
        super().__init__()
        self.n = int(n)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        # in_spec is the (common) spec of each branch.
        return in_spec.with_(channels=(self.n,) + in_spec.channels)

    def apply(self, carry, xs):
        if len(xs) != self.n:
            raise ValueError(f"Combine: expected {self.n} inputs, got "
                             f"{len(xs)}")
        if isinstance(xs[0], Complex):
            return carry, Complex(torch.stack([x.re for x in xs]),
                                  torch.stack([x.im for x in xs]))
        return carry, torch.stack(list(xs))


class Tee(Processor):
    """Fan-out: one input block to N branch processors; the output is the
    tuple of their outputs (the spec is the first branch's; all of them
    are :attr:`branch_specs`)."""

    def __init__(self, branches: Sequence[Processor]):
        super().__init__()
        self.branches: List[Processor] = list(branches)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        self._branch_specs = tuple(b.bind(in_spec) for b in self.branches)
        return self._branch_specs[0]

    @property
    def branch_specs(self) -> Tuple[StreamSpec, ...]:
        return self._branch_specs

    def _init_carry(self, device) -> Carry:
        """Each branch's initial state on ``device``."""
        return tuple(b.init_carry(device) for b in self.branches)

    def apply(self, carry: Carry, x):
        new_carries, outs = [], []
        for b, c in zip(self.branches, carry):
            with span("stage:" + type(b).__name__):
                c, y = b.apply(c, x)
            new_carries.append(c)
            outs.append(y)
        return tuple(new_carries), tuple(outs)
