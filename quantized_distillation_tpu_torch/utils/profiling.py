"""Device timing, roofline and tracing on the card (PyTorch port of the JAX
package's ``utils/profiling.py``).

- :func:`graph_ms` / :func:`measure`: device time of a call without the
  host's time to issue it: back-to-back calls captured in one CUDA graph,
  replayed between CUDA events (a loop of Python calls timed with events
  measures the host's 30-50 µs a call instead, once a kernel takes only
  microseconds).
- :data:`CHIP_PEAKS` and :func:`roofline`: achieved FLOP/s and bytes/s of a
  call against the card's data-sheet peaks, and which of the two bounds it.
  ``chip_smoke.py`` computes every kernel's bound from these peaks.
- :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from .._device import resolve_device

# NVIDIA's data sheet, SXM part, dense rates (no sparsity) at the full 700 W
# power limit: bf16 tensor-core and f32 (outside the tensor cores) FLOP/s,
# HBM3 bytes/s. A card set below 700 W runs slower under load.
CHIP_PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bf16_tflops": 989.0, "f32_tflops": 67.0, "hbm_gbs": 3350.0},
}


def detect_chip(device="cuda") -> str:
    """The name of the card behind ``device``
    (``torch.cuda.get_device_properties``); raises without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"detect_chip needs a CUDA device, not {device!r}")
    return torch.cuda.get_device_properties(dev).name


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def peaks(chip: str) -> Dict[str, float]:
    """The :data:`CHIP_PEAKS` row whose key is in the card's name ``chip``."""
    for key, row in CHIP_PEAKS.items():
        if key in chip:
            return row
    raise KeyError(f"no peak rates for {chip!r}; known: {sorted(CHIP_PEAKS)}")


def graph_ms(fn: Callable[[], object], calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` back-to-back calls
    captured in one CUDA graph, replayed ``reps`` times between CUDA events;
    the median."""
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


def measure(fn: Callable[[], object], *, calls: int = 20, reps: int = 5) -> float:
    """Device seconds per call of ``fn`` (:func:`graph_ms`)."""
    return graph_ms(fn, calls, reps) * 1e-3


@dataclass
class RooflineResult:
    name: str
    seconds: float
    tflops: float
    gbs: float
    pct_compute: float
    pct_memory: float
    bound: str

    def line(self) -> str:
        return (
            f"{self.name}: {self.seconds*1e6:.0f} us | "
            f"{self.tflops:.1f} TFLOP/s ({self.pct_compute:.0f}% peak) | "
            f"{self.gbs:.0f} GB/s ({self.pct_memory:.0f}% peak) | {self.bound}-bound"
        )


def roofline(name: str, seconds: float, flops: float, bytes_moved: float,
             chip: Optional[str] = None) -> RooflineResult:
    """Achieved rates of a call of ``seconds`` that does ``flops`` and moves
    ``bytes_moved``, as shares of the bf16 and memory peaks of ``chip`` (a
    card's name; default the card's own), and whether its arithmetic
    intensity puts it above the ridge point (compute) or below (memory)."""
    pk = peaks(chip or detect_chip())
    tf = flops / seconds / 1e12
    gb = bytes_moved / seconds / 1e9
    intensity = flops / max(bytes_moved, 1.0)
    ridge = pk["bf16_tflops"] * 1e12 / (pk["hbm_gbs"] * 1e9)
    return RooflineResult(
        name=name, seconds=seconds, tflops=tf, gbs=gb,
        pct_compute=100.0 * tf / pk["bf16_tflops"],
        pct_memory=100.0 * gb / pk["hbm_gbs"],
        bound="compute" if intensity > ridge else "memory",
    )


@contextlib.contextmanager
def trace(logdir: str, *, device="cuda"):
    """``torch.profiler`` over the block (host activity, and the card's
    kernels on a CUDA ``device``); writes ``<logdir>/trace.json``, a Chrome
    trace (open it in ui.perfetto.dev). Yields the profiler, whose
    ``key_averages()`` sums time by kernel."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
