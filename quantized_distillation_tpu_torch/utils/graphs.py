"""A whole function of fixed-shape CUDA tensors run as one captured CUDA graph.

The port's counterpart of a jitted JAX program: the serving searches
(``serve.beam.beam_search``, ``serve.infer.beam_search_packed``) run on the
card as one graph each, so one replay launches every kernel of a search,
and the host makes one call where it made hundreds.

A :class:`CapturedCall` copies its inputs into static buffers, replays, and
returns clones of the graph's outputs. The kernel wrappers' launch counters
count Python calls, so a replay would count nothing: the capture measures
the launches it recorded, puts the counters back as they were before the
warm-up and the capture, and every call adds the captured launches again.
A :class:`GraphCache` keeps a few captured calls, keyed by everything that
fixes the captured work (see :func:`signature`).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Sequence

import torch
from torch import nn

from ..kernels import launch_counts, set_launch_counts


def _map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a tuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        return tuple(_map(fn, t) for t in tree)
    raise TypeError(f"unsupported output node {type(tree)}")


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {name: after[name] - before[name] for name in after}


class CapturedCall:
    """``fn(*inputs)`` (CUDA tensors in, a tuple tree of tensors out)
    captured once as a CUDA graph.

    Capture: one warm-up call on a side stream, under
    ``torch.cuda.set_sync_debug_mode("error")`` so that any host sync in
    ``fn`` raises (a graph cannot hold one), then ``torch.cuda.graph``. A
    failed capture raises; nothing falls back to eager calls. The warm-up
    and the capture must launch the same kernels, or the work depends on
    more than the inputs' shapes and the capture raises too."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        self.inputs = tuple(x.clone() for x in inputs)
        before = launch_counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                fn(*self.inputs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(side)
        warm = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)
            self.launches = _delta(launch_counts(), warm)
        finally:
            set_launch_counts(before)
        if self.launches != _delta(warm, before):
            raise RuntimeError(
                f"capture launched {self.launches}, its warm-up {_delta(warm, before)}: "
                "the captured work depends on more than the inputs' shapes"
            )

    def __call__(self, *inputs: torch.Tensor):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        counts = launch_counts()
        set_launch_counts({n: counts[n] + d for n, d in self.launches.items()})
        return _map(torch.clone, self.outputs)


def signature(obj) -> Hashable:
    """What a captured graph reads of ``obj``: the address, shape, dtype and
    device of every tensor (a graph reads its operands at the addresses it
    was captured with) and the value of every other field. Takes tensors,
    modules (config and parameters), dataclasses, tuples and hashable
    values."""
    if isinstance(obj, torch.Tensor):
        return (obj.data_ptr(), tuple(obj.shape), obj.dtype, obj.device)
    if isinstance(obj, nn.Module):
        return (type(obj), getattr(obj, "cfg", None),
                tuple(signature(t) for t in obj.parameters()),
                tuple(signature(t) for t in obj.buffers()))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj),) + tuple(
            signature(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, tuple):
        return tuple(signature(x) for x in obj)
    hash(obj)  # a value that cannot key the cache raises here
    return obj


class GraphCache:
    """At most ``SIZE`` captured calls, the least recently used dropped
    first. ``captures`` counts the captures made."""

    SIZE = 8

    def __init__(self):
        self.captures = 0
        self._calls: OrderedDict = OrderedDict()

    def run(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor]):
        """``fn(*inputs)`` through the captured call stored under ``key``
        and the inputs' shapes, dtypes and devices, captured first if there
        is none. ``key`` must hold everything else that fixes the work
        ``fn`` launches. TF32 settings are part of the key."""
        key = (key, torch.backends.cuda.matmul.allow_tf32,
               torch.get_float32_matmul_precision(),
               tuple((tuple(x.shape), x.dtype, x.device) for x in inputs))
        call = self._calls.get(key)
        if call is None:
            call = CapturedCall(fn, inputs)
            self.captures += 1
            self._calls[key] = call
            while len(self._calls) > self.SIZE:
                self._calls.popitem(last=False)
        else:
            self._calls.move_to_end(key)
        return call(*inputs)
