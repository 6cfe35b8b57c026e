"""Knowledge-distillation training of a 4-bit student through the port's
train entry, ``train.make_train_step(donate=True)`` (``TrainStep``: one
CUDA graph a batch signature), with the task the configuration's family
names (``train.nmt_task``; ``train.lm_task(thread_carry=True)``).

Set-up makes the student's and the teacher's weights on the device from
the seed, loads them into the port's models, builds one step and one train
state, stages the mix's cycle of batches on the device and drives the step
through its first steps, which the reference follows: three steps on three
different batches of the cycle's first shape (the first captures that
shape's graph, the next two replay it), then two of every other shape (a
capture, a replay), so that every graph the window replays has been
compared. The window hands the same step and state batch after batch of
the cycle, through the step's own call, and syncs only at its end.
``train_tokens_per_s`` is the real (non-pad) target tokens of every step
over the window's seconds.

Once the window has closed and the program's state is freed, the reference
(``portbench.reference.train.follow``) follows the first steps from the
same weights on the same batches (``portbench.checks.train_gaps``).
"""

from __future__ import annotations

import time
from typing import Dict

import torch
from torch.profiler import record_function

from .. import checks, traffic, weights
from ..harness import Cell, Outcome
from ..reference.numerics import no_tf32
from ..reference.train import B1, Recipe, follow
from ..trace import record, traced
from .serve_offline import _free, _sync, _with_context

CHECKED = 3


def _shapes(cfg: dict, side: str):
    m = cfg[side]
    make = weights.seq2seq_shapes if cfg["family"] == "seq2seq" else weights.lm_shapes
    return make(cfg["vocab"], m["embed_dim"], m["hidden"], m["num_layers"])


def _models(cfg: dict, dev):
    from quantized_distillation_tpu_torch.models import make_lm, make_seq2seq

    def build(side):
        if cfg["family"] == "seq2seq":
            return make_seq2seq("student_medium", cfg["vocab"], cfg["vocab"], device=dev,
                                dropout=cfg["dropout"], **cfg[side])
        return make_lm("student_medium", cfg["vocab"], device=dev, dropout=cfg["dropout"],
                       **cfg[side])

    return build("student"), build("teacher")


def _recipe(cfg: dict) -> Recipe:
    t, q = cfg["train"], cfg["quant"]
    return Recipe(family=cfg["family"], layers_student=cfg["student"]["num_layers"],
                  layers_teacher=cfg["teacher"]["num_layers"], bits=q["bits"],
                  bucket_size=q["bucket_size"], learning_rate=t["learning_rate"],
                  clip_norm=t["clip_norm"], distill_weight=t["distill_weight"],
                  temperature=t["temperature"])


def _batches(cell: Cell, seed: int, dev):
    """The mix's cycle staged on the device, and each batch's real target
    tokens."""
    cfg, tr = cell.config, cell.traffic
    if cfg["family"] == "seq2seq":
        cycle = traffic.pairs(tr, cfg["vocab"], seed)
    else:
        cycle = traffic.stream_windows(tr, cfg["vocab"], seed)
    staged = [{k: torch.as_tensor(v).to(dev, torch.float32 if v.dtype.kind == "f" else torch.int64)
               for k, v in b.items()} for b in cycle]
    return staged, [traffic.real_target_tokens(b) for b in cycle]


def _order(cycle: list, family: str):
    """(the checked steps' batch indices, where the window starts): for
    seq2seq the first three batches of the first batch's shape, then the
    first two of every other shape in the order the cycle first sends them,
    the window from the cycle's start; for the LM (one shape, the carry
    threaded through the stream) its first three windows, the window from
    the fourth."""
    if family != "seq2seq":
        return list(range(CHECKED)), CHECKED
    key = [tuple(b["src"].shape) for b in cycle]
    checked = []
    for k in dict.fromkeys(key):
        checked += [i for i, kk in enumerate(key) if kk == k][:CHECKED if k == key[0] else 2]
    return checked, 0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float,
        control: str = None) -> Outcome:
    """One run of the cell (see the module docstring). ``control`` (a
    format of ``reference.numerics``) also reads the control and the
    half-batch fault, each in the program's place, into ``Outcome.notes``."""
    from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
    from quantized_distillation_tpu_torch.train import (
        build_optimizer, create_train_state, lm_initial_carry, lm_task, make_train_step,
        nmt_task)

    dev = torch.device(device)
    no_tf32()
    cfg, tr = cell.config, cell.traffic
    t, q = cfg["train"], cfg["quant"]
    w_student = weights.make(_shapes(cfg, "student"), weights.stream_seed(seed, 0), dev)
    w_teacher = weights.make(_shapes(cfg, "teacher"), weights.stream_seed(seed, 1), dev)
    student, teacher = _models(cfg, dev)
    weights.load_into(student, w_student)
    weights.load_into(teacher, w_teacher)
    carry = None
    if cfg["family"] == "seq2seq":
        task = nmt_task(student, teacher, device=dev)
    else:
        task = lm_task(student, teacher, thread_carry=True, device=dev)
        carry = lm_initial_carry(student, tr["batch_size"], teacher)
    tx = build_optimizer(TrainConfig(learning_rate=t["learning_rate"], clip_norm=t["clip_norm"]))
    step = make_train_step(
        task, tx, quant=QuantSpec(bits=q["bits"], bucket_size=q["bucket_size"]),
        distill=DistillSpec(weight=t["distill_weight"], temperature=t["temperature"]),
        donate=True, device=dev)
    state = create_train_state(dict(student.named_parameters()), tx, carry=carry, device=dev)
    cycle, real = _batches(cell, seed, dev)
    checked, start = _order(cycle, cfg["family"])

    # the first steps, which the reference follows
    program = {"loss": [], "grad": {}, "change": {}}
    for k, i in enumerate(checked):
        state, metrics = step(state, cycle[i], seed)
        program["loss"].append(metrics["loss"])
        if k == 0:
            program["grad"] = {n: torch.linalg.vector_norm(m) / (1 - B1)
                               for n, m in state.opt_state.mu.items()}
    program["change"] = {n: torch.linalg.vector_norm(p.detach() - w_student[n])
                         for n, p in state.params.items()}
    program = {k: ([float(x) for x in v] if isinstance(v, list) else
                   {n: float(x) for n, x in v.items()}) for k, v in program.items()}
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    bad.add_((~torch.isfinite(metrics["loss"])).to(torch.int64))  # its kernels load here
    _sync(dev)
    setup_s = time.perf_counter() - started

    tokens = done = 0
    rec = None

    def one():
        nonlocal state, tokens, done
        i = (start + done) % len(cycle)
        with record_function("portbench.step"):
            state, metrics = step(state, cycle[i], seed)
        bad.add_((~torch.isfinite(metrics["loss"])).to(torch.int64))
        tokens += real[i]
        done += 1

    t0 = time.perf_counter()
    if trace:
        n = tr["trace_units"]
        with traced(dev) as prof:
            shapes_traced = []
            for _ in range(n):
                b = cycle[(start + done) % len(cycle)]
                shapes_traced.append(_unit_shape(b, cfg))
                one()
        rec = record(prof)
        rec.update(units=n, unit_shapes=shapes_traced)
    while time.perf_counter() - t0 < seconds:
        one()
    _sync(dev)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int(bad)

    carry0 = carry  # the zeros the state started from (it holds a copy)
    del step, state, task, student, teacher
    _free(dev)
    recipe = _recipe(cfg)
    batches = [cycle[i] for i in checked]
    reference = follow(recipe, w_student, w_teacher, batches, carry0)
    readings = checks.train_gaps(program, reference)
    notes = checks.train_worst(program, reference)
    if control is not None:
        for name, kw in ((control, {"fmt": control}), ("half", {"fault": "half"})):
            got = checks.train_gaps(follow(recipe, w_student, w_teacher, batches, carry0, **kw),
                                    reference)
            notes.update({f"{name}.{k}": v for k, v in got.items()})
    return Outcome(
        setup_s=setup_s, rates={"train_tokens_per_s": tokens / window}, attempted=done,
        failed=failed, memory_peak_bytes=int(peak),
        checks=[(k, readings[k], cell.limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")],
        record=_with_context(rec, cell), busy_s=rec and rec["busy_s"],
        window_s=rec and rec["window_s"], notes=notes)


def _unit_shape(batch: Dict[str, torch.Tensor], cfg: dict) -> dict:
    if cfg["family"] == "seq2seq":
        rows, src = batch["src"].shape
        return {"rows": rows, "src_len": src, "tgt_len": batch["tgt_in"].shape[1]}
    rows, length = batch["input"].shape
    return {"rows": rows, "src_len": 0, "tgt_len": length}
