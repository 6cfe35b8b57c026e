"""Run a function on N ranks, one spawned process each, over an initialised
``torch.distributed`` process group.

:func:`run_ranks` is the port's single-host launcher (what ``torchrun``
does for a script): every rank joins one group through a ``FileStore``
under a fresh directory (no port to collide with other runs), each group
has a timeout, the parent waits at most ``join_timeout`` seconds, and a
rank that fails ends the run: the others are killed and the failure is
raised with the rank's traceback, so no rank is left blocked in a
collective. Over NCCL (one rank a card; fewer cards than local ranks
raise) each rank's card is made current before its group is initialised,
and every CUDA graph the rank still holds is freed before the group is
destroyed. The function must be importable by name (a module-level
function): spawned children import its module again, not the caller's
``__main__`` block.

Across hosts, :func:`run_node` starts this node's share of the ranks
(``world_size / nnodes`` of them, global ranks ``node_rank * local + i``)
with a TCP rendezvous at ``master_addr:master_port``, with the same
failure handling; :func:`env_rank` reads what ``torchrun`` sets for a
process that is itself one rank.
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

from ..utils.graphs import release_graphs


def _child(call, rank, local, world, backend, init_method, timeout, out):
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)  # the ranks share the host's cores
        if backend == "nccl":
            # the rank's card is current before the group exists, so that no
            # communicator or barrier binds to card 0; and every connection is
            # made when a communicator is created, never inside a graph capture
            # (the first collective of a kind may otherwise connect its peers)
            torch.cuda.set_device(local % torch.cuda.device_count())
            os.environ.setdefault("NCCL_RUNTIME_CONNECT", "0")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            # a graph holding collectives goes before its communicators
            release_graphs()
            if backend == "nccl":
                torch.cuda.synchronize()
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
    tmp = tempfile.mkdtemp(prefix="qdt_ranks_", dir=store_dir)
    try:
        return _spawn(fn, list(range(world_size)), world_size, args, backend,
                      f"file://{os.path.join(tmp, 'store')}", timeout, join_timeout, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_node(
    fn: Callable[..., Any],
    world_size: int,
    *,
    nnodes: int,
    node_rank: int,
    master_addr: str,
    master_port: int,
    args: Sequence[Any] = (),
    backend: str = "gloo",
    timeout: float = 120.0,
    join_timeout: float = 300.0,
) -> List[Any]:
    """This node's ranks of a ``world_size``-rank group over ``nnodes``
    hosts: ``fn(rank, world_size, *args)`` on global ranks ``node_rank *
    local`` to ``(node_rank + 1) * local - 1`` (``local = world_size /
    nnodes``), joined at ``tcp://master_addr:master_port`` (node 0 serves
    the store) → their return values, in rank order. Failures as
    :func:`run_ranks`."""
    if world_size % nnodes or not 0 <= node_rank < nnodes:
        raise ValueError(f"{world_size} ranks do not split over node {node_rank} of {nnodes}")
    local = world_size // nnodes
    tmp = tempfile.mkdtemp(prefix="qdt_node_")
    try:
        return _spawn(fn, list(range(node_rank * local, (node_rank + 1) * local)), world_size,
                      args, backend, f"tcp://{master_addr}:{master_port}", timeout,
                      join_timeout, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rank_device(device, local_rank: int) -> torch.device:
    """Where a rank's tensors live: the CPU, or card ``local_rank % cards``
    (made current; ranks beyond the cards share them), TF32 off so an f32
    product on the card is a true f32 product."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and PyTorch sees no card")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def local_backend(device, local_ranks: int) -> str:
    """The backend of ``local_ranks`` ranks on one host with their tensors
    on ``device``: NCCL where every local rank has a card of its own (NCCL
    takes one rank a card), else gloo, the ranks sharing the cards and
    their collectives going through the host."""
    cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    return "nccl" if cuda and torch.cuda.device_count() >= local_ranks else "gloo"


def env_rank() -> Optional[tuple]:
    """``(rank, world_size, local_rank, local_world_size)`` from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``), or None outside it; such a process joins with
    ``init_process_group(init_method="env://")``."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    return (int(os.environ["RANK"]), world, int(os.environ.get("LOCAL_RANK", "0")),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def _spawn(fn, ranks, world_size, args, backend, init_method, timeout, join_timeout, tmp):
    """Start one child per global rank in ``ranks``, wait for all of their
    results (raising the first failure) and end every child."""
    if backend == "nccl" and torch.cuda.device_count() < len(ranks):
        raise RuntimeError(f"NCCL takes one rank a card: {len(ranks)} local ranks, "
                           f"{torch.cuda.device_count()} card(s) visible")
    ctx = mp.get_context("spawn")
    # the function and its arguments go through a file: a spawned child reads
    # its start-up pipe only after importing the caller's main module, so a
    # large argument there would start the ranks one after another
    call = os.path.join(tmp, "call.pkl")
    with open(call, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    out = ctx.Queue()
    procs = {
        r: ctx.Process(target=_child, daemon=True,
                       args=(call, r, i, world_size, backend, init_method, timeout, out))
        for i, r in enumerate(ranks)
    }
    results: dict = {}
    try:
        for p in procs.values():
            p.start()
        deadline = time.monotonic() + join_timeout
        grace = None
        while len(results) < len(ranks):
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(ranks) - set(results))} "
                                   f"did not finish within {join_timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in procs.items()
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
        for p in procs.values():
            p.join(timeout=30)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
    return [results[r] for r in ranks]
