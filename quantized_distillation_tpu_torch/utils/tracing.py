"""The port's spans and counters.

:func:`span` (or :func:`spanned`, each call of a function) names a
stretch of host work on the profiler's own timeline. While a
``torch.profiler`` records (an operator's trace through
:func:`utils.profiling.trace`, a benchmark's window), it enters a record
function named ``qdt.<name>``; otherwise it does nothing but one check.
Spans nest: a span's parent is the span around it, so the spans of one
search or train step sit under its outer span (``serve.search``,
``train.step``). The record function is of the profiler's function scope,
like an operator's, and not of its user scope, whose ranges the profiler
also mirrors onto the device timeline as if they were device work. No span
sits inside a function a CUDA graph captures: a replay would not run it.

:func:`count` adds to a named counter and :func:`counts` reads them all,
with the kernel wrappers' launch counters under ``launch.<name>``.

Inside a captured CUDA graph no host counter fires on a replay, so code
that a graph captures counts on the device: :func:`device_count` adds a
tensor in place to a named int64 buffer on the tensor's device (made at
the first call, which must not be under a capture: a train step's first
call, its graph's warm-up, makes it), :func:`device_counts` reads every
buffer with one sync and :func:`reset_device_counts` zeroes them in place,
so the graphs that add to them keep adding. They cost one small kernel a
counter a call and stay on, like :func:`count`.
"""

from __future__ import annotations

import contextlib
import functools
from collections import defaultdict
from typing import Callable, ContextManager, Dict, List, Union

import torch
from torch._C._profiler import _RecordFunctionFast

from ..kernels import launch_counts

PREFIX = "qdt."

_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = defaultdict(int)
_DEVICE_COUNTS: Dict[str, torch.Tensor] = {}


def span(name: str) -> ContextManager:
    """A ``qdt.<name>`` range on the profiler's timeline while a profiler
    records; a shared empty context otherwise."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(PREFIX + name)
    return _OFF


def spanned(name: str) -> Callable[[Callable], Callable]:
    """Decorator: each call of the function is the span ``name``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    """Every counter now, and each kernel launch counter as
    ``launch.<name>``."""
    out = dict(_COUNTS)
    out.update((f"launch.{n}", c) for n, c in launch_counts().items())
    return out


def device_count(name: str, value: torch.Tensor) -> None:
    """Add ``value`` (an integer tensor, of one shape for a name) in place
    to the device counter ``name``, without a sync."""
    buf = _DEVICE_COUNTS.get(name)
    if buf is None:
        if value.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device counter {name!r} made under a capture: "
                               "count once before capturing")
        buf = _DEVICE_COUNTS[name] = torch.zeros(value.shape, dtype=torch.int64,
                                                 device=value.device)
    elif buf.shape != value.shape or buf.device != value.device:
        raise ValueError(f"device counter {name!r} is {tuple(buf.shape)} on {buf.device}, "
                         f"got {tuple(value.shape)} on {value.device}")
    with torch.no_grad():
        buf.add_(value.detach())


def device_counts() -> Dict[str, Union[int, List[int]]]:
    """Every device counter now (a 0-dim one as an int, others as lists),
    read with one sync a device."""
    by_device: Dict[torch.device, List[str]] = defaultdict(list)
    for name, buf in _DEVICE_COUNTS.items():
        by_device[buf.device].append(name)
    out: Dict[str, Union[int, List[int]]] = {}
    for names in by_device.values():
        bufs = [_DEVICE_COUNTS[n] for n in names]
        flat = torch.cat([b.reshape(-1) for b in bufs]).cpu().tolist()
        at = 0
        for name, buf in zip(names, bufs):
            part = flat[at:at + buf.numel()]
            at += buf.numel()
            out[name] = part[0] if buf.dim() == 0 else part
    return out


def reset_device_counts() -> None:
    """Zero every device counter in place."""
    with torch.no_grad():
        for buf in _DEVICE_COUNTS.values():
            buf.zero_()
