"""Knowledge-distillation training of a 4-bit DeepSeek-V2 student (one
card's share of an expert-parallel deployment) through the port's train
entry: ``train.make_train_step(donate=True)`` with ``train.lm_task``, no
carry, the student and the teacher from ``models.make_deepseek_v2``.

The configuration file holds the published ``config.json`` keys as run:
``n_routed_experts`` is the experts this card holds of each MoE layer,
``router_experts`` the experts the router scores (the published count),
``first_expert`` the first held one. The teacher is the configuration in
f32; the student starts from the teacher's weights (self-distillation for
quantization) and is 4-bit in every matrix but the router
(``quant.exclude``).

Set-up makes the teacher's weights on the device from the seed (the
student's are a copy), builds one step and one train state, stages the
mix's cycle of Zipf windows (``traffic.stream_windows``, each row a
sequence from position 0) and drives the step through the first three
windows (a capture, two replays), which the reference follows. The window
hands the step the cycle's windows from the fourth on, through the step's
own call, and syncs only at its end. ``train_tokens_per_s`` is the tokens
of every step in the window over the window's seconds: a step the window
closes on counts whole, and the window's seconds run until it ends.

The expert layer's device counters (``utils.tracing``) are zeroed when the
window opens and read once after it: a dropped pair counts as a failed
step. A traced run also reads them after its traced steps, and each traced
unit's shape carries the held pairs a step of the student
(``held_pairs``) and of the teacher (``held_pairs_teacher``), from which
``metrics/grouped_matmul_roofline.py`` and ``mfu.moe_train`` count
operations.

Once the window has closed and the program's state is freed, the reference
(``portbench.reference.deepseek_v2.follow``) follows the first steps from
the same weights on the same windows (``portbench.checks.train_gaps``).
"""

from __future__ import annotations

import time
from typing import Dict

import torch
from torch.profiler import record_function

from .. import checks, traffic, weights
from ..harness import Cell, Outcome
from ..reference import deepseek_v2 as reference
from ..reference.numerics import no_tf32
from ..reference.train import B1
from ..trace import record, traced
from .serve_offline import _free, _sync, _with_context

CHECKED = 3


def model_config(cfg: dict) -> dict:
    """The configuration as the model reads it: the router over
    ``router_experts``."""
    return dict(cfg, n_routed_experts=cfg["router_experts"])


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed`` on ``device``, in one draw: matrices
    N(0, 1/fan_in) with the fan-in their second-to-last dim (the embedding
    N(0, 1/hidden)), RMSNorm scales 1."""
    mats = {n: s for n, s in shapes.items() if len(s) >= 2}
    sizes = [int(torch.Size(s).numel()) for s in mats.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(mats.items(), sizes):
        fan_in = shape[-1] if name == "embed.embedding" else shape[-2]
        out[name] = flat[at:at + size].view(shape).mul_(fan_in ** -0.5)
        at += size
    for name, shape in shapes.items():
        if len(shape) < 2:
            out[name] = torch.ones(shape, device=device)
    return {n: out[n] for n in shapes}


def _counted(counts: dict, side: str) -> int:
    return int(sum(counts.get(f"moe.{side}.held_pairs", [0])))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float,
        control: str = None) -> Outcome:
    """One run of the cell (see the module docstring). ``control`` (a
    format of ``reference.numerics``) also reads the control and the
    half-batch fault, each in the program's place, into ``Outcome.notes``."""
    from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
    from quantized_distillation_tpu_torch.models import make_deepseek_v2
    from quantized_distillation_tpu_torch.train import (
        build_optimizer, create_train_state, lm_task, make_train_step)
    from quantized_distillation_tpu_torch.utils.tracing import (
        device_counts, reset_device_counts)

    dev = torch.device(device)
    no_tf32()
    cfg, tr = cell.config, cell.traffic
    t, q = cfg["train"], cfg["quant"]
    model = model_config(cfg)
    first, held = cfg["first_expert"], cfg["n_routed_experts"]
    w_teacher = make_weights(reference.shapes(model, held), weights.stream_seed(seed, 1), dev)
    w_student = {n: w.clone() for n, w in w_teacher.items()}

    def build(side):
        return make_deepseek_v2(model, first_expert=first, n_held=held,
                                counters=f"moe.{side}", device=dev)

    student, teacher = build("student"), build("teacher")
    weights.load_into(student, w_student)
    weights.load_into(teacher, w_teacher)
    task = lm_task(student, teacher, device=dev)
    tx = build_optimizer(TrainConfig(learning_rate=t["learning_rate"], clip_norm=t["clip_norm"]))
    quant = QuantSpec(bits=q["bits"], bucket_size=q["bucket_size"],
                      exclude_substrings=QuantSpec().exclude_substrings + tuple(q["exclude"]))
    step = make_train_step(
        task, tx, quant=quant,
        distill=DistillSpec(weight=t["distill_weight"], temperature=t["temperature"]),
        donate=True, device=dev)
    state = create_train_state(dict(student.named_parameters()), tx, device=dev)
    cycle = [{k: torch.as_tensor(v).to(dev, torch.int64) for k, v in b.items()}
             for b in traffic.stream_windows(tr, cfg["vocab_size"], seed)]
    real = [int(b["target"].numel()) for b in cycle]

    # the first steps, which the reference follows
    program = {"loss": [], "grad": {}, "change": {}}
    for k in range(CHECKED):
        state, metrics = step(state, cycle[k], seed)
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
        i = (CHECKED + done) % len(cycle)
        with record_function("portbench.step"):
            state, metrics = step(state, cycle[i], seed)
        bad.add_((~torch.isfinite(metrics["loss"])).to(torch.int64))
        tokens += real[i]
        done += 1

    t0 = time.perf_counter()
    reset_device_counts()
    if trace:
        n = tr["trace_units"]
        with traced(dev) as prof:
            shapes_traced = []
            for _ in range(n):
                b = cycle[(CHECKED + done) % len(cycle)]
                shapes_traced.append({"rows": b["input"].shape[0], "src_len": 0,
                                      "tgt_len": b["input"].shape[1]})
                one()
        rec = record(prof)
        counts = device_counts()
        for s in shapes_traced:
            s.update(held_pairs=_counted(counts, "student") / n,
                     held_pairs_teacher=_counted(counts, "teacher") / n)
        rec.update(units=n, unit_shapes=shapes_traced)
    while time.perf_counter() - t0 < seconds:
        one()
    _sync(dev)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counts = device_counts()
    dropped = counts.get("moe.student.dropped", 0) + counts.get("moe.teacher.dropped", 0)
    failed = int(bad) + int(dropped != 0)
    notes = {"pairs": f"held pairs a step, student {_counted(counts, 'student') / done!r} "
                      f"teacher {_counted(counts, 'teacher') / done!r}, dropped {dropped}"}

    del step, state, task, student, teacher
    _free(dev)
    if dev.type == "cuda":
        # the cuBLAS workspace of each stream a capture warmed up on stays
        # allocated inside a large cached segment, which empty_cache then
        # cannot return: release it, so that runs in one process do not grow
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
    batches = cycle[:CHECKED]
    ref = reference.follow(model, first, held, w_student, w_teacher, batches)
    readings = checks.train_gaps(program, ref)
    notes.update(checks.train_worst(program, ref))
    if control is not None:
        for name, kw in ((control, {"fmt": control}), ("half", {"fault": "half"})):
            got = checks.train_gaps(
                reference.follow(model, first, held, w_student, w_teacher, batches, **kw), ref)
            notes.update({f"{name}.{k}": v for k, v in got.items()})
    return Outcome(
        setup_s=setup_s, rates={"train_tokens_per_s": tokens / window}, attempted=done,
        failed=failed, memory_peak_bytes=int(peak),
        checks=[(k, readings[k], cell.limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")],
        record=_with_context(rec, cell), busy_s=rec and rec["busy_s"],
        window_s=rec and rec["window_s"], notes=notes)
