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
"""

from __future__ import annotations

import contextlib
import functools
from collections import defaultdict
from typing import Callable, ContextManager, Dict

import torch
from torch._C._profiler import _RecordFunctionFast

from ..kernels import launch_counts

PREFIX = "qdt."

_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = defaultdict(int)


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
