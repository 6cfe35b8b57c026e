"""Data-parallel KD training across cards: the train path of
``paths/train_kd.py`` with one rank a card (``parallel.launch.run_ranks``,
NCCL on the cards), each rank stepping ``train.make_train_step(mesh=
parallel.make_mesh(cards, 1), donate=True)`` on its rows of every global
batch (``parallel.place_batch``), the gradients all-reduced in f32 inside
the step's CUDA graph.

Every rank makes the same weights from the seed and the same cycle of
global batches (``tokens_per_batch`` padded target tokens, one bucket a
batch) and runs the same first steps as ``train_kd``, which warm up every
shape.
The window starts and ends with a barrier on rank 0's clock; every 8 steps
rank 0 tells the ranks whether to go on, so all run the same steps.
``train_tokens_per_s`` is the real target tokens of every global batch over
the window's seconds. A traced run traces the first steps on every rank;
the record is rank 0's, its busy and window seconds the ranks' mean. Each
rank reports the modules of JAX or the JAX package it holds once its window
has closed, and the run reports them with its own.

Once the ranks have ended, this process follows the first steps with
the reference on the global batches, one process (``reference.train``),
against rank 0's readings.
"""

from __future__ import annotations

import statistics
import time

import torch
import torch.distributed as dist
from torch.profiler import record_function

from .. import checks, weights
from ..harness import Cell, Outcome, loaded_forbidden
from ..reference.numerics import no_tf32
from ..reference.train import B1, follow
from ..trace import record, traced
from .train_kd import _batches, _models, _order, _recipe, _shapes, _unit_shape

AGREE_EVERY = 8


def _rank(rank: int, world: int, cell: Cell, seed: int, seconds: float, trace: bool,
          device: str, started: float) -> dict:
    from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
    from quantized_distillation_tpu_torch.parallel import make_mesh, place_batch
    from quantized_distillation_tpu_torch.parallel.launch import rank_device
    from quantized_distillation_tpu_torch.train import (
        build_optimizer, create_train_state, make_train_step, nmt_task)

    dev = rank_device(device, rank)
    no_tf32()
    cfg = cell.config
    t, q = cfg["train"], cfg["quant"]
    mesh = make_mesh(world, 1)
    w_student = weights.make(_shapes(cfg, "student"), weights.stream_seed(seed, 0), dev)
    w_teacher = weights.make(_shapes(cfg, "teacher"), weights.stream_seed(seed, 1), dev)
    student, teacher = _models(cfg, dev)
    weights.load_into(student, w_student)
    weights.load_into(teacher, w_teacher)
    task = nmt_task(student, teacher, device=dev)
    tx = build_optimizer(TrainConfig(learning_rate=t["learning_rate"], clip_norm=t["clip_norm"]))
    step = make_train_step(
        task, tx, quant=QuantSpec(bits=q["bits"], bucket_size=q["bucket_size"]),
        distill=DistillSpec(weight=t["distill_weight"], temperature=t["temperature"]),
        donate=True, mesh=mesh, device=dev)
    state = create_train_state(dict(student.named_parameters()), tx, device=dev)
    cycle, real = _batches(cell, seed, dev)
    local = [place_batch(b, mesh, device=dev) for b in cycle]
    checked, start = _order(cycle, cfg["family"])

    program = {"loss": [], "grad": {}, "change": {}}
    for k, i in enumerate(checked):
        state, metrics = step(state, local[i], seed)
        program["loss"].append(float(metrics["loss"]))
        if k == 0:
            program["grad"] = {n: float(torch.linalg.vector_norm(m) / (1 - B1))
                               for n, m in state.opt_state.mu.items()}
    program["change"] = {n: float(torch.linalg.vector_norm(p.detach() - w_student[n]))
                         for n, p in state.params.items()}
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    bad.add_((~torch.isfinite(metrics["loss"])).to(torch.int64))  # its kernels load here
    del w_teacher
    go = torch.ones((), dtype=torch.int64, device=dev)
    dist.broadcast(go, src=0)
    done = tokens = 0
    out = {}

    def one():
        nonlocal state, done, tokens
        i = (start + done) % len(cycle)
        with record_function("portbench.step"):
            state, metrics = step(state, local[i], seed)
        bad.add_((~torch.isfinite(metrics["loss"])).to(torch.int64))
        tokens += real[i]
        done += 1

    _barrier(dev)
    setup_s = time.perf_counter() - started
    t0 = time.perf_counter()
    if trace:
        n = cell.traffic["trace_units"]
        shapes = [_unit_shape(cycle[(start + j) % len(cycle)], cfg) for j in range(n)]
        with traced(dev, ready=lambda: _barrier(dev)) as prof:
            for _ in range(n):
                one()
        rec = record(prof)
        rec.update(units=n, unit_shapes=shapes)
        out["record"] = rec if rank == 0 else {k: rec[k] for k in ("busy_s", "window_s")}
    while True:
        if done % AGREE_EVERY == 0:
            go.fill_(int(time.perf_counter() - t0 < seconds))
            dist.broadcast(go, src=0)
            if not int(go):
                break
        one()
    _barrier(dev)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out.update(program=program, setup_s=setup_s, window_s=window, tokens=tokens, steps=done,
               failed=int(bad), peak=int(peak), loaded=loaded_forbidden())
    return out


def _barrier(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


RANK = _rank  # what each rank runs


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float,
        control: str = None) -> Outcome:
    """One run of the cell on ``cell.chips`` ranks (see the module
    docstring); ``control`` as in ``train_kd.run``."""
    from quantized_distillation_tpu_torch.parallel.launch import run_ranks

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    ranks = run_ranks(RANK, cell.chips, args=(cell, seed, seconds, trace, device, started),
                      backend=backend, timeout=300.0, join_timeout=900.0)
    r0 = ranks[0]
    rec = None
    if trace:
        rec = dict(r0["record"], config=cell.config, traffic=cell.traffic, peaks=cell.peaks,
                   cards=cell.chips)
        rec["busy_s"] = statistics.mean(r["record"]["busy_s"] for r in ranks)
        rec["window_s"] = statistics.mean(r["record"]["window_s"] for r in ranks)

    # the reference, one process on the global batches, after the ranks ended
    no_tf32()
    cfg = cell.config
    w_student = weights.make(_shapes(cfg, "student"), weights.stream_seed(seed, 0), dev)
    w_teacher = weights.make(_shapes(cfg, "teacher"), weights.stream_seed(seed, 1), dev)
    cycle, _ = _batches(cell, seed, dev)
    checked, _ = _order(cycle, cfg["family"])
    batches = [cycle[i] for i in checked]
    recipe = _recipe(cfg)
    reference = follow(recipe, w_student, w_teacher, batches)
    readings = checks.train_gaps(r0["program"], reference)
    notes = checks.train_worst(r0["program"], reference)
    if control is not None:
        for name, kw in ((control, {"fmt": control}), ("half", {"fault": "half"})):
            got = checks.train_gaps(follow(recipe, w_student, w_teacher, batches, **kw),
                                    reference)
            notes.update({f"{name}.{k}": v for k, v in got.items()})
    return Outcome(
        setup_s=r0["setup_s"], rates={"train_tokens_per_s": r0["tokens"] / r0["window_s"]},
        attempted=r0["steps"], failed=sum(r["failed"] for r in ranks),
        memory_peak_bytes=max(r["peak"] for r in ranks),
        checks=[(k, readings[k], cell.limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")],
        cards=cell.chips, record=rec, busy_s=rec and rec["busy_s"],
        window_s=rec and rec["window_s"], notes=notes,
        loaded=sorted({m for r in ranks for m in r["loaded"]}))
