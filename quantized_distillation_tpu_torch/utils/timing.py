"""Device time of a kernel call on the card, without the host's issue time."""

from __future__ import annotations

import statistics

import torch


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` back-to-back calls
    captured in one CUDA graph, replayed ``reps`` times between CUDA events;
    the median. A loop of Python calls timed with events measures the host's
    time to issue each call instead, once a kernel takes only microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)
