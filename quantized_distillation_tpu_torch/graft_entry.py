"""Entry points of the flagship workload: the 4-bit STE forward of the
seq2seq student and a dry run of the sharded KD step on an n-rank mesh
(the PyTorch port's counterpart of the repository root's
``__graft_entry__.py``).

:func:`entry` returns the flagship student's forward under 4-bit
straight-through fake-quant (``student_medium``, V = 8192, B = 8, 24 × 24)
and its example arguments. On the card the forward launches the fake-quant
kernel (``csrc/fake_quant.cu``) once, over every quantizable leaf; JAX's
"jittable" is the port's CUDA graph (:class:`..utils.graphs.CapturedCall`),
which ``__main__`` runs beside the eager call.

:func:`dryrun_multichip` spawns ``n`` ranks (:func:`..parallel.launch.run_ranks`)
on a ``(n / model, model)`` mesh, ``model`` = 2 where ``n`` is even, and
each rank runs, at the JAX function's toy shapes:

1. one KD train step with the student tensor parallel over ``model``
   (``place_params_seq2seq``) and the batch over ``data``
   (``make_train_step(mesh=, param_specs=)``). The teacher stays whole on
   every rank: the port's tensor-parallel design (JAX splits it too);
2. that step's collective budget (``parallel.comm.collective_budget``) with
   the f32 gradient reduce and with ``preferred_grad_reduce_dtype``;
3. the sharded serving search (``shard_decoder`` → ``beam_search_sharded``,
   4-bit, f32 compute) and the budget of one sharded decode step.

The caller's process then prints the flagship 1 → 2 host projection: the
exact gradient payload of ``student_medium`` at V = 32000 from the port's
own parameter shapes (pure data parallel, and with the leaves that
``seq2seq_pspecs`` splits over ``model`` carrying 1/model of their bytes)
over an assumed 25 GB/s link, against a step time measured on the card
(``--measure-step``: :func:`measure_flagship_step`; ``--step-from PATH``:
the 4-bit step of the record ``bench --train --family seq2seq`` writes,
``bench_flagship_train_torch.json``, read by :func:`read_step`; or
``step_seconds``). Without a step time it prints the payloads and "step not
measured". Last it runs ``scripts.multihost_smoke --procs 2`` as a
subprocess.

Backend: NCCL with one rank a card where ``n`` is at most the cards
PyTorch sees, else gloo with the ranks sharing the cards (collectives
through the host); gloo on ``device="cpu"``. A rank that fails, a check
that fails and a smoke that exits non-zero fail the call.

    python -m quantized_distillation_tpu_torch.graft_entry --measure-step
    python -m quantized_distillation_tpu_torch.graft_entry --step-from bench_flagship_train_torch.json
    python -m quantized_distillation_tpu_torch.graft_entry --device cpu --n 8
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .config import BeamConfig, DistillSpec, TrainConfig
from .kernels import launch_counts, launches_since
from .models import make_seq2seq
from .parallel import make_mesh, seq2seq_pspecs
from .parallel.comm import (
    CollectiveOp,
    CommBudget,
    collective_budget,
    format_budget,
    scaling_estimate,
)
from .parallel.launch import local_backend, rank_device, run_ranks
from .parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size
from .scripts.comm_budget import kd_batch
from .scripts.multihost_smoke import QUANT, TOY_LEN, toy_setup
from .serve import (
    beam_search_sharded,
    encode_packed,
    expand_to_beams,
    make_sharded_decode_step_topk,
)
from .train import (
    build_optimizer,
    create_train_state,
    make_train_step,
    nmt_task,
    preferred_grad_reduce_dtype,
)
from .utils.graphs import CapturedCall
from .utils.profiling import card_line

ENTRY_VOCAB, ENTRY_B, ENTRY_LEN = 8192, 8, 24
FLAGSHIP_VOCAB, FLAGSHIP_B, FLAGSHIP_LEN = 32000, 128, 24  # scripts.comm_budget's shape
LINK_BYTES_PER_S = 25e9  # assumed inter-host rate of the projection, not measured
SEARCH = BeamConfig(beam_size=2, max_len=4)
KBEAM = 2  # the decode-step budget's k
TIMEOUT = 300.0  # seconds a collective may wait
SMOKE_TIMEOUT = 600.0


def entry(*, device="cuda"):
    """→ ``(fn, example_args)``: ``fn(params, src, src_len, tgt_in)`` is the
    flagship student's forward (logits ``[8, 24, 8192]``) on its parameters
    fake-quantized to 4 bits with a straight-through gradient; ``params``
    are ``named_parameters()`` names → tensors, the example's the model's
    own seeded weights. Raises on ``device="cuda"`` without a card."""
    from .train.quantize_tree import ste_quantize_tree

    dev = resolve_device(device)
    model = make_seq2seq("student_medium", ENTRY_VOCAB, ENTRY_VOCAB, device=dev, seed=0)
    src = torch.ones((ENTRY_B, ENTRY_LEN), dtype=torch.int64, device=dev)
    src_len = torch.full((ENTRY_B,), ENTRY_LEN, dtype=torch.int64, device=dev)
    tgt_in = torch.ones((ENTRY_B, ENTRY_LEN), dtype=torch.int64, device=dev)

    def fn(params, src, src_len, tgt_in):
        return model.forward_with(ste_quantize_tree(params, QUANT), src, src_len, tgt_in)

    return fn, (dict(model.named_parameters()), src, src_len, tgt_in)


def graphed_entry(fn, example_args) -> CapturedCall:
    """``fn`` of :func:`entry` captured as one CUDA graph over the example's
    tensors; call it with the flat tensors ``(*params.values(), src,
    src_len, tgt_in)``."""
    params, *inputs = example_args
    names = list(params)

    def flat(*tensors):
        return (fn(dict(zip(names, tensors[:len(names)])), *tensors[len(names):]),)

    return CapturedCall(flat, list(params.values()) + inputs)


def measure_flagship_step(*, device="cuda", reps: int = 5) -> float:
    """Seconds of the graphed 4-bit STE KD step at ``scripts.comm_budget``'s
    shape (teacher 2x500 → ``student_medium``, V = 32000, B = 128, L = 24,
    Adam 1e-3, clip 5, dropout 0), host clock to a read of the loss, median
    of ``reps`` replays after the capturing call. The step, its state and
    its graph are freed, and the allocator's cache emptied, before it
    returns."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the flagship step is measured on the card only")
    v = FLAGSHIP_VOCAB
    teacher = make_seq2seq("teacher", v, v, dropout=0.0, device=dev, seed=1)
    student = make_seq2seq("student_medium", v, v, dropout=0.0, device=dev, seed=0)
    tx = build_optimizer(TrainConfig(learning_rate=1e-3, clip_norm=5.0))
    state = create_train_state(dict(student.named_parameters()), tx, quant=QUANT, device=dev)
    step = make_train_step(nmt_task(student, teacher, device=dev), tx, quant=QUANT,
                           distill=DistillSpec(), device=dev)
    batch = kd_batch(FLAGSHIP_B, FLAGSHIP_LEN)
    state, metrics = step(state, batch, 0)  # captures the graph
    float(metrics["loss"])
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, i + 1)
        float(metrics["loss"])  # reads the device: the step has ended
        times.append(time.perf_counter() - t0)
    del teacher, student, tx, state, step, metrics
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return statistics.median(times)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of :func:`dryrun_multichip`: the KD step twice (f32 and
    reduced-precision gradient reduce), the sharded search and one sharded
    decode step → their results, budgets and launches."""
    dev = rank_device(spec["device"], rank)
    mp = spec["model"]
    mesh = make_mesh(world // mp, mp)
    t = TOY_LEN
    toy = toy_setup(mesh, dev, 2 * world, dropout=spec["dropout"], params=spec["params"])
    out = {}
    for key, reduce_dtype in (("f32", None), ("reduced", preferred_grad_reduce_dtype(dev))):
        state, step = toy.train_step(reduce_dtype)
        before = launch_counts()
        with collective_budget(mesh) as budget:
            state, metrics = step(state, toy.batch, 0)
            loss = float(metrics["loss"])
        out[key] = {"loss": loss, "budget": budget, "graphed": step.graphed,
                    "launches": launches_since(before),
                    "reduce_dtype": str(reduce_dtype or torch.float32)}
        del state, step, metrics

    student, sdec = toy.student, toy.sdec
    dp, d = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    bs = max(dp, 2)
    src = torch.ones((bs, t), dtype=torch.int64, device=dev)
    src_len = torch.full((bs,), t, dtype=torch.int64, device=dev)
    before = launch_counts()
    toks, scores = beam_search_sharded(student, sdec, src, src_len, SEARCH, mesh, device=dev)
    out["search"] = {"tokens": toks.cpu().numpy(), "scores": scores.cpu().numpy(),
                     "launches": launches_since(before)}

    rows = slice(d * (bs // dp), (d + 1) * (bs // dp))
    with torch.no_grad():
        keys, enc_out, enc_mask, st0 = encode_packed(student, sdec, src[rows], src_len[rows])
        state = expand_to_beams(st0, KBEAM)
        tokens = torch.ones(((bs // dp) * KBEAM,), dtype=torch.int64, device=dev)
        sstep = make_sharded_decode_step_topk(sdec, mesh, KBEAM)
        before = launch_counts()
        with collective_budget(mesh) as budget:
            _, (vals, idx, lse) = sstep(state, tokens, keys, enc_out, enc_mask)
            finite = bool(torch.isfinite(vals).all() and torch.isfinite(lse).all())
    out["decode_step"] = {"budget": budget, "launches": launches_since(before),
                          "finite": finite}
    out["mesh"] = {DATA_AXIS: dp, MODEL_AXIS: axis_size(mesh, MODEL_AXIS)}
    return out


def flagship_payloads(model_par: int) -> dict:
    """Gradient payload bytes of ``student_medium`` at V = 32000 from the
    port's parameter shapes: every parameter in f32 (the pure data-parallel
    upper bound), and with each parameter that ``seq2seq_pspecs`` splits
    over ``model`` carrying 1/``model_par`` of its bytes; each also in 2
    bytes an element."""
    model = make_seq2seq("student_medium", FLAGSHIP_VOCAB, FLAGSHIP_VOCAB, device="cpu")
    params = dict(model.named_parameters())
    specs = seq2seq_pspecs(params)
    f32 = sum(4 * p.numel() for p in params.values())
    tp = sum(4 * p.numel() // (model_par if MODEL_AXIS in specs[n] else 1)
             for n, p in params.items())
    return {"f32, pure-DP upper bound": f32, "bf16, pure-DP upper bound": f32 // 2,
            f"f32, tp={model_par} sharded": tp, f"bf16, tp={model_par} sharded": tp // 2}


def read_step(path) -> dict:
    """The flagship record that ``bench --train --family seq2seq`` writes
    (``bench.FLAGSHIP_FILE``); raises unless it holds a positive, finite
    ``train_step_seconds``."""
    with open(path) as f:
        record = json.load(f)
    step = record.get("train_step_seconds")
    if not isinstance(step, (int, float)) or not math.isfinite(step) or step <= 0:
        raise ValueError(f"{path}: no positive train_step_seconds ({step!r})")
    return record


def projection(payloads: dict, step_seconds: Optional[float], card: str,
               record: Optional[dict] = None) -> dict:
    """Print the flagship 1 → 2 host projection of each payload → name →
    ``{"payload_bytes", "serialized", "overlapped"}`` (efficiencies None
    without a step time). Ring all-reduce over 2 hosts sends the payload
    once a host. ``record`` (:func:`read_step`'s) says where the step was
    measured, in place of this run's ``card`` and the
    :func:`measure_flagship_step` shape."""
    if record is not None:
        card = record["card"]
        what = f"{record['workload']}, written by {record['written_by']}"
    else:
        what = (f"the graphed 4-bit KD step at teacher 2x500 -> student_medium, V "
                f"{FLAGSHIP_VOCAB}, B {FLAGSHIP_B}, L {FLAGSHIP_LEN}")
    if step_seconds is None:
        print("  flagship step provenance: step not measured (run with --measure-step or "
              "pass step_seconds): payloads only, no efficiency")
    else:
        print(f"  flagship step provenance: {step_seconds * 1e3:.3f} ms, {what}, measured on "
              f"{card}; link {LINK_BYTES_PER_S / 1e9:.0f} GB/s assumed, not measured")
    out = {}
    for name, payload in payloads.items():
        budget = CommBudget([CollectiveOp("all-reduce", payload, DATA_AXIS, 2)])
        row = {"payload_bytes": payload, "serialized": None, "overlapped": None}
        if step_seconds is None:
            print(f"  flagship 1->2 host projection ({name} grad reduce, "
                  f"{payload / 1e6:.1f}MB wire): step not measured")
        else:
            for key, overlap in (("serialized", False), ("overlapped", True)):
                row[key] = scaling_estimate(budget, step_seconds, hosts=2,
                                            dcn_bytes_per_s=LINK_BYTES_PER_S,
                                            overlap=overlap)["efficiency"]
            print(f"  flagship 1->2 host projection ({name} grad reduce, measured step "
                  f"{step_seconds * 1e3:.2f}ms on {card}, {payload / 1e6:.1f}MB wire "
                  f"@{LINK_BYTES_PER_S / 1e9:.0f}GB/s assumed): serialized efficiency "
                  f"{row['serialized']:.3f}, overlapped {row['overlapped']:.3f}")
        out[name] = row
    return out


def multihost_smoke(device, procs: int = 2, timeout_s: float = SMOKE_TIMEOUT) -> str:
    """``python -m ...scripts.multihost_smoke --procs N --device D`` as a
    subprocess → the last line of its output; raises if it exits non-zero
    or outlasts ``timeout_s``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", f"{__package__}.scripts.multihost_smoke", "--procs", str(procs),
           "--device", str(device)]
    try:
        res = subprocess.run(cmd, cwd=root, timeout=timeout_s, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        print(f"dryrun_multichip: multi-process smoke TIMEOUT after {timeout_s}s")
        raise
    if res.returncode:
        print(res.stdout)
        print(res.stderr, file=sys.stderr)
        raise RuntimeError(f"multi-process smoke failed rc={res.returncode}")
    return (res.stdout.strip().splitlines() or [""])[-1]


def dryrun_multichip(
    n_devices: int,
    *,
    device="cuda",
    dropout: Optional[float] = None,
    params: Optional[dict] = None,
    step_seconds: Optional[float] = None,
    step_record: Optional[dict] = None,
    dcn_smoke: bool = True,
) -> dict:
    """One sharded KD step, its budgets, the flagship projection, the
    sharded search and its decode-step budget on ``n_devices`` ranks, and
    the multi-process smoke (see the module docstring); prints the JAX
    function's lines in its order → a report: ``loss``, ``mesh``,
    ``backend``, ``budgets`` (``f32``, ``reduced``, ``decode_step``: each a
    :class:`..parallel.comm.CommBudget`), ``payloads``, ``decode`` (token
    shape, scores), ``search`` (each rank's tokens and scores),
    ``launches`` (each rank's, by stage), ``smoke``
    (the smoke's last line, or None). ``dropout`` None is the preset's
    (0.3); ``params`` (``{"student": tree, "teacher": tree}`` of numpy
    arrays in the flax layout) replaces the seeded weights; ``step_seconds``
    is the flagship step measured on the card, ``step_record`` the record it
    was read from (:func:`read_step`), if any."""
    resolve_device(device)
    dev_type = torch.device(device).type
    n = int(n_devices)
    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    backend = local_backend(device, n)
    if dev_type != "cuda":
        rule = f"gloo: {n} ranks on the host (device cpu)"
    elif backend == "nccl":
        rule = f"nccl: one rank a card ({n} ranks, {torch.cuda.device_count()} cards)"
    else:
        rule = (f"gloo: {n} ranks share {torch.cuda.device_count()} card(s), collectives "
                "through the host (NCCL takes one rank a card)")
    print(f"dryrun_multichip({n}): backend {rule}")
    spec = {"device": dev_type, "model": model_par, "dropout": dropout, "params": params}
    ranks = run_ranks(_rank, n, args=(spec,), backend=backend, timeout=TIMEOUT,
                      join_timeout=3 * TIMEOUT)
    r0 = ranks[0]
    mesh = r0["mesh"]
    loss = r0["f32"]["loss"]
    _require(math.isfinite(loss), f"non-finite loss {loss}")
    for r, res in enumerate(ranks):
        _require(res["f32"]["loss"] == loss, f"rank {r} loss {res['f32']['loss']} != {loss}")
        for key in ("f32", "reduced", "decode_step"):
            _require(res[key]["budget"] == r0[key]["budget"],
                     f"rank {r} issued other {key} collectives")
        _require(np.array_equal(res["search"]["tokens"], r0["search"]["tokens"]),
                 f"rank {r} searched other tokens")
    print(f"dryrun_multichip({n}): mesh {mesh} loss {loss:.4f} OK")

    budgets = {key: r0[key]["budget"] for key in ("f32", "reduced", "decode_step")}
    print("dryrun_multichip comm budget (train step, f32 grad reduce):")
    print(format_budget(budgets["f32"]))
    print(f"dryrun_multichip comm budget (train step, {r0['reduced']['reduce_dtype']} grad "
          "reduce):")
    print(format_budget(budgets["reduced"]))
    card = card_line() if dev_type == "cuda" else "no card (device cpu)"
    payloads = flagship_payloads(model_par)
    proj = projection(payloads, step_seconds, card, step_record)
    toy = scaling_estimate(budgets["f32"], 1.0, hosts=2)["dcn_bytes_per_step"]
    print(f"  toy-shapes data-axis wire at 2 hosts: {toy / 1e6:.3f}MB/step (no step time at "
          "these shapes: no efficiency)")

    toks, scores = r0["search"]["tokens"], r0["search"]["scores"]
    _require(bool(np.isfinite(scores).all()), f"sharded search scores not finite: {scores}")
    print(f"dryrun_multichip({n}): sharded serving decode {tuple(toks.shape)} OK")

    decode = budgets["decode_step"]
    _require(all(res["decode_step"]["finite"] for res in ranks),
             "sharded decode step candidates not finite")
    print("dryrun_multichip comm budget (sharded decode step):")
    print(format_budget(decode))
    by_axis = decode.bytes_by_axis()
    print(f"  decode-step wire bytes: model {by_axis.get(MODEL_AXIS, 0)}B, data "
          f"{by_axis.get(DATA_AXIS, 0)}B: slots are independent over data; the vocab-parallel "
          f"merge rides model (rows x (2k+1) x 4B x (mp-1)/mp)")

    tail = None
    if dcn_smoke:
        tail = multihost_smoke(dev_type)
        print(f"dryrun_multichip: multi-process step OK ({tail})")
    return {
        "n": n, "loss": loss, "mesh": mesh, "backend": backend, "rule": rule,
        "losses": {key: [res[key]["loss"] for res in ranks] for key in ("f32", "reduced")},
        "graphed": [res["f32"]["graphed"] for res in ranks],
        "budgets": budgets,
        "payloads": payloads, "projection": proj, "step_seconds": step_seconds, "card": card,
        "decode": {"tokens_shape": tuple(toks.shape), "scores": scores},
        "search": [{key: res["search"][key] for key in ("tokens", "scores")} for res in ranks],
        "launches": [{key: res[key]["launches"] for key in ("f32", "reduced", "search",
                                                            "decode_step")}
                     for res in ranks],
        "smoke": tail,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="ranks of the dry run (default: the cards, or 8 on the CPU)")
    step = ap.add_mutually_exclusive_group()
    step.add_argument("--step-seconds", type=float, default=None,
                      help="the flagship 4-bit KD step, measured on the card")
    step.add_argument("--measure-step", action="store_true",
                      help="measure the flagship step on the card first")
    step.add_argument("--step-from", default=None, metavar="PATH",
                      help="the flagship step from the record that `python -m "
                      "quantized_distillation_tpu_torch.bench --train --family seq2seq` writes "
                      "(bench_flagship_train_torch.json)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    fn, example = entry(device=dev)
    out = fn(*example)
    print("entry forward:", tuple(out.shape), out.dtype)
    if dev.type == "cuda":
        params, *inputs = example
        graphed = graphed_entry(fn, example)(*params.values(), *inputs)[0]
        print("entry forward (CUDA graph):", tuple(graphed.shape), graphed.dtype,
              "bit-equal to eager:", torch.equal(graphed, out))
    del fn, example, out
    step_seconds, record = args.step_seconds, None
    if args.measure_step:
        step_seconds = measure_flagship_step(device=dev)
    elif args.step_from:
        record = read_step(args.step_from)
        step_seconds = record["train_step_seconds"]
    n = args.n or (torch.cuda.device_count() if dev.type == "cuda" else 8)
    dryrun_multichip(n, device=dev.type, step_seconds=step_seconds, step_record=record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
