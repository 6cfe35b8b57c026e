"""Run a function on N ranks, one spawned process each, over an initialised
``torch.distributed`` process group.

:func:`run_ranks` is the port's single-host launcher (what ``torchrun``
does for a script): every rank joins one group through a ``FileStore``
under a fresh directory (no port to collide with other runs), each group
has a timeout, the parent waits at most ``join_timeout`` seconds, and a
rank that fails ends the run: the others are killed and the failure is
raised with the rank's traceback, so no rank is left blocked in a
collective. The function must be importable by name (a module-level
function): spawned children import its module again, not the caller's
``__main__`` block.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(call, rank, world, backend, store, timeout, out):
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))


def run_ranks(
    fn: Callable[..., Any],
    world_size: int,
    *,
    args: Sequence[Any] = (),
    backend: str = "gloo",
    timeout: float = 120.0,
    join_timeout: float = 300.0,
    store_dir: Optional[str] = None,
) -> List[Any]:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks of one
    ``backend`` process group → each rank's return value, in rank order.
    ``timeout`` bounds each collective, ``join_timeout`` the whole run.
    Each rank runs one intra-op thread (``fn`` may set more).
    Raises ``RuntimeError`` with the first failing rank's traceback, or
    ``TimeoutError``; every child has ended when it returns or raises."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="qdt_ranks_", dir=store_dir)
    store = os.path.join(tmp, "store")
    # the function and its arguments go through a file: a spawned child reads
    # its start-up pipe only after importing the caller's main module, so a
    # large argument there would start the ranks one after another
    call = os.path.join(tmp, "call.pkl")
    with open(call, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    out = ctx.Queue()
    procs = [
        ctx.Process(target=_child, daemon=True,
                    args=(call, r, world_size, backend, store, timeout, out))
        for r in range(world_size)
    ]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout
        grace = None
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(results))} "
                                   f"did not finish within {join_timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:  # its result may still be in the pipe: a short grace
                    grace = grace or time.monotonic() + 5.0
                    if time.monotonic() > grace:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
