"""A whole function of fixed-shape CUDA tensors run as one captured CUDA graph.

The port's counterpart of a jitted JAX program: the serving searches
(``serve.beam.beam_search``, ``serve.infer.beam_search_packed``) run on the
card as one graph each, so one replay launches every kernel of a search,
and the host makes one call where it made hundreds.

A :class:`CapturedCall` copies its inputs into static buffers, replays, and
returns clones of the graph's outputs. A :class:`CapturedStep` is a
function with no inputs or outputs that updates persistent buffers in
place, replayed as often as asked: one decode step of the
continuous-batching engine's slot grid, or one train step
(``train.make_train_step``), whose warm-up is the step's first call
(``counted_warmup``) and whose random generators the graph reads anew at
each replay (``generators``). The kernel wrappers' launch counters
count Python calls, so a replay would count nothing: the capture measures
the launches it recorded, puts the counters back as they were before the
warm-up and the capture (after the warm-up, where it is counted), and
every replay adds the captured launches again.
Other records a replay must repeat (the collectives of the multi-device
paths) come through a recorder registered with :func:`register_recorder`:
the warm-up's records are dropped, the capture's kept, and every replay
makes them again.
A :class:`GraphCache` keeps a few captured calls, keyed by everything that
fixes the captured work (see :func:`signature`).
Under a profiler, captures, replays and a call's input copies and output
clones are spans (``graph.capture``, ``graph.replay``, ``graph.inputs``,
``graph.outputs``; :mod:`.tracing`), and the counters ``graph.captures``,
``graph.replays`` and ``graph.evictions`` count them always.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..kernels import launch_counts, set_launch_counts
from .tracing import count, span

# (redirected, replay) of each registered recorder, in registration order
_RECORDERS: List[Tuple[Callable, Callable]] = []


def register_recorder(redirected: Callable, replay: Callable) -> None:
    """Register records a replay must repeat besides kernel launches.
    ``redirected(into)`` is a context manager inside which the records go
    to the list ``into`` (None: nowhere) instead of where they usually go;
    ``replay(records, times)`` makes ``records`` again ``times`` times."""
    _RECORDERS.append((redirected, replay))


@contextlib.contextmanager
def _redirected(into: Sequence[Optional[list]]):
    """Every registered recorder's records into its list of ``into``."""
    with contextlib.ExitStack() as stack:
        for (redirected, _), sink in zip(_RECORDERS, into):
            stack.enter_context(redirected(sink))
        yield


def _map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a tuple or dataclass tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        return tuple(_map(fn, t) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    raise TypeError(f"unsupported output node {type(tree)}")


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {name: after[name] - before[name] for name in after}


@contextlib.contextmanager
def host_syncs_raise():
    """Inside the block a host sync on the card raises
    (``torch.cuda.set_sync_debug_mode("error")``; the mode is restored
    after)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _capture(fn: Callable, args: Sequence[torch.Tensor] = (), *, counted_warmup: bool = False,
             generators: Sequence[torch.Generator] = ()):
    """``fn(*args)`` captured as a CUDA graph → (graph, outputs, launches a
    replay adds, each recorder's records a replay makes again). One warm-up
    call on a side stream, under
    ``torch.cuda.set_sync_debug_mode("error")`` so that any host sync in
    ``fn`` raises (a graph cannot hold one), then ``torch.cuda.graph``. A
    failed capture raises; nothing falls back to eager calls. The warm-up
    and the capture must launch the same kernels, or the work depends on
    more than the inputs' shapes and the capture raises too. The launch
    counters end as they were before the warm-up, or, with
    ``counted_warmup`` (the warm-up is a call the caller wanted: a train
    step's first), as they were after it, and its records are made as a
    call's are. ``generators`` (CUDA ``torch.Generator``s that ``fn``
    draws from) are registered with the graph: each replay draws from
    their seed and offset at that time, as an eager call would."""
    before = launch_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    sinks = contextlib.nullcontext() if counted_warmup else _redirected([None] * len(_RECORDERS))
    with host_syncs_raise(), torch.cuda.stream(side), sinks:
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    warm = launch_counts()
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    # An unreachable graph that the cyclic garbage collector frees during the
    # capture (its reset) invalidates the capture: collect first, then hold
    # the collector off until the capture ends.
    gc.collect()
    gc_was_on = gc.isenabled()
    gc.disable()
    records = [[] for _ in _RECORDERS]
    try:
        with torch.cuda.graph(graph), _redirected(records):
            outputs = fn(*args)
        launches = _delta(launch_counts(), warm)
    finally:
        if gc_was_on:
            gc.enable()
        set_launch_counts(warm if counted_warmup else before)
    if launches != _delta(warm, before):
        raise RuntimeError(
            f"capture launched {launches}, its warm-up {_delta(warm, before)}: "
            "the captured work depends on more than the inputs' shapes"
        )
    count("graph.captures")
    return graph, outputs, launches, records


def _count(launches: Dict[str, int], records, times: int) -> None:
    counts = launch_counts()
    set_launch_counts({n: counts[n] + times * d for n, d in launches.items()})
    for (_, replay), recs in zip(_RECORDERS, records):
        replay(recs, times)


class CapturedCall:
    """``fn(*inputs)`` (CUDA tensors in, a tuple or dataclass tree of
    tensors out) captured once as a CUDA graph (see :func:`_capture`)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        self.inputs = tuple(x.clone() for x in inputs)
        with span("graph.capture"):
            self.graph, self.outputs, self.launches, self.records = _capture(fn, self.inputs)

    def __call__(self, *inputs: torch.Tensor):
        with span("graph.inputs"):
            for static, x in zip(self.inputs, inputs):
                static.copy_(x)
        with span("graph.replay"):
            self.graph.replay()
        _count(self.launches, self.records, 1)
        count("graph.replays")
        with span("graph.outputs"):
            return _map(torch.clone, self.outputs)


class CapturedStep:
    """``fn()``, which updates tensors that outlive it in place (inputs and
    outputs are those tensors), captured once as a CUDA graph (see
    :func:`_capture`; the warm-up runs ``fn`` once for real, so capture it
    where one more call changes nothing that matters, or pass
    ``counted_warmup=True`` where the warm-up is the first call that was
    wanted). ``replay(n)`` runs it ``n`` times and adds ``n`` times its
    launches to the counters."""

    def __init__(self, fn: Callable[[], None], *, counted_warmup: bool = False,
                 generators: Sequence[torch.Generator] = ()):
        with span("graph.capture"):
            self.graph, _, self.launches, self.records = _capture(
                fn, counted_warmup=counted_warmup, generators=generators)

    def replay(self, n: int = 1) -> None:
        for _ in range(n):
            with span("graph.replay"):
                self.graph.replay()
        _count(self.launches, self.records, n)
        count("graph.replays", n)


_CACHES: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()


def release_graphs() -> None:
    """Free every graph that nothing but a :class:`GraphCache` or a
    reference cycle holds: each cache emptied, then the cyclic garbage
    collected. A process calls it before it destroys the process groups
    whose collectives its graphs hold."""
    for cache in list(_CACHES):
        cache.clear()
    gc.collect()


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


def precision_key() -> Hashable:
    """The TF32 settings, which fix the kernels a captured f32 product or
    convolution runs."""
    return (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


class GraphCache:
    """At most ``SIZE`` captured calls, the least recently used dropped
    first. ``captures`` counts the captures made."""

    SIZE = 8

    def __init__(self):
        self.captures = 0
        self._calls: OrderedDict = OrderedDict()
        _CACHES.add(self)

    def clear(self) -> None:
        """Drop every captured call."""
        self._calls.clear()

    def run(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor]):
        """``fn(*inputs)`` through the captured call stored under ``key``
        and the inputs' shapes, dtypes and devices, captured first if there
        is none. ``key`` must hold everything else that fixes the work
        ``fn`` launches. TF32 settings are part of the key."""
        key = (key, precision_key(), tuple((tuple(x.shape), x.dtype, x.device) for x in inputs))
        call = self._calls.get(key)
        if call is None:
            call = CapturedCall(fn, inputs)
            self.captures += 1
            self._calls[key] = call
            while len(self._calls) > self.SIZE:
                self._calls.popitem(last=False)
                count("graph.evictions")
        else:
            self._calls.move_to_end(key)
        return call(*inputs)
