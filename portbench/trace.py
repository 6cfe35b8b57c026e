"""What a traced window leaves for the per-layer metrics.

A path runs some units of its work (searches, train steps) inside
:func:`traced`, a ``torch.profiler`` window with the host and the card's
activity, marked by the benchmark's own host spans (``portbench.*``,
``torch.profiler.record_function``). :func:`record` reduces the trace to
the record every metric reader (``portbench/metrics/<name>.py``) reads:

- ``window_s``: the host's seconds of the window span, synchronised at both
  ends, so every device operation of its units lies inside it;
- ``busy_s``: seconds in which some device operation (kernel, copy, set)
  ran, the union of their intervals within the window;
- ``ops``: device operation name → [seconds, count];
- ``idle_gaps``: the window's idle device time by what the host was doing
  at each gap's middle (the benchmark's span, then the innermost host
  operation), name → seconds;
- ``spans``: the benchmark's span name → list of host seconds.

The path adds ``units`` and ``unit_shapes``, the configuration, the mix
and the peaks.
"""

from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

WINDOW = "portbench.window"
PREFIX = "portbench."
COPIES = ("Memcpy", "Memset")


@contextlib.contextmanager
def traced(device: torch.device, ready=None):
    """A profiler over the block, whose work is marked as the window;
    yields the profiler. The block must end with the device synchronised.
    ``ready()``, when given, runs once the profiler has started and before
    the window opens (ranks meet there, whose profilers start at different
    times)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        if ready is not None:
            ready()
        with record_function(WINDOW):
            yield prof
            if device.type == "cuda":
                torch.cuda.synchronize(device)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end) intervals of an [n, 2] array, sorted."""
    if intervals.size == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.float64)


def _label_gaps(gaps: np.ndarray, host: list) -> Dict[str, float]:
    """Idle seconds by label: at each gap's middle, the innermost of the
    benchmark's spans and the innermost other host event that cover it (a
    sweep over the host events sorted by start)."""
    idle: Dict[str, float] = defaultdict(float)
    active: list = []  # heap of (end, start, name, ours)
    i = 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][0] <= mid:
            s, e, name, ours = host[i]
            heapq.heappush(active, (e, s, name, ours))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        best = {True: None, False: None}
        for e, s, name, ours in active:
            if best[ours] is None or e - s < best[ours][1]:
                best[ours] = (name[len(PREFIX):] if ours else name, e - s)
        label = "/".join(x[0] for x in (best[True], best[False]) if x is not None)
        idle[label or "host idle"] += (g1 - g0) * 1e-9
    return idle


def record(prof) -> dict:
    """The traced window reduced as the module docstring says."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    spans: Dict[str, List[float]] = defaultdict(list)
    host = []  # (start, end, name, is our span)
    dev = []
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        if e.name().startswith(PREFIX) and e.device_type() != DeviceType.CPU:
            continue  # the spans' mirror on the device timeline: no device work
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if name == WINDOW:
                window = (start, end)
            elif name.startswith(PREFIX):
                spans[name[len(PREFIX):]].append((end - start) * 1e-9)
                host.append((start, end, name, True))
            else:
                host.append((start, end, name, False))
        elif end > start:
            dev.append((start, end, e.name()))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        ops[name][0] += (e - s) * 1e-9
        ops[name][1] += 1
    busy = _union(np.array([(max(s, w0), min(e, w1)) for s, e, _ in dev
                            if e > w0 and s < w1], dtype=np.float64).reshape(-1, 2))
    busy_ns = float((busy[:, 1] - busy[:, 0]).sum()) if busy.size else 0.0
    # idle gaps: the window minus the busy intervals
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle = _label_gaps(gaps, sorted(host))
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9, "ops": dict(ops),
            "idle_gaps": dict(idle), "spans": dict(spans)}


def kernels(rec: dict) -> Dict[str, List[float]]:
    """The record's kernels (device operations other than copies and sets)."""
    return {n: v for n, v in rec["ops"].items() if not n.startswith(COPIES)}


def matching(rec: dict, patterns) -> List[float]:
    """[seconds, count] summed over the kernels whose name holds one of
    ``patterns``."""
    total = [0.0, 0]
    for name, (sec, count) in kernels(rec).items():
        if any(p in name for p in patterns):
            total[0] += sec
            total[1] += count
    return total


def breakdown(rec: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing."""
    ops = sorted(((n[:120], v[0]) for n, v in rec["ops"].items()), key=lambda x: -x[1])
    gaps = sorted(((n[:120], s) for n, s in rec["idle_gaps"].items()), key=lambda x: -x[1])
    return {"device_ops": [list(x) for x in ops[:top]],
            "idle_gaps": [list(x) for x in gaps[:top]]}
