"""Structured metrics logging (the port's own copy of the JAX package's
``utils/metrics.py``, which imports no JAX but is not shared): JSONL event
streams (one file per run) with stdout mirroring, and an items/s counter.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream with optional stdout echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, event: str, step: Optional[int] = None, **fields: Any) -> Dict:
        rec = {"event": event, "t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in fields.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            parts = [f"[{event}]"]
            if step is not None:
                parts.append(f"step={step}")
            parts += [
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("event", "t", "step")
            ]
            print(" ".join(parts), flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class Throughput:
    """Running items/s counter (images/s, tokens/s)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._items = 0

    def add(self, n: int):
        self._items += n

    @property
    def per_second(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._items / dt if dt > 0 else 0.0
