"""Headline benchmark of the PyTorch port on one card: 4-bit WMT13-scale
student serving throughput, the continuous-batching engine, and the 4-bit
STE knowledge-distillation train step (the port's counterpart of the
repository root's ``bench.py``, with its modes, flags, metric names, units
and one printed JSON line).

    python -m quantized_distillation_tpu_torch.bench                 # serving
    python -m quantized_distillation_tpu_torch.bench --engine
    python -m quantized_distillation_tpu_torch.bench --train --family seq2seq|wrn|lm
    python -m quantized_distillation_tpu_torch.bench --quick --device cpu   # tests only

Serving (default): tokens/s of ``beam_search_packed`` on the 4-bit packed
decoder (bf16 compute: the dequant-matmul, fused generator and beam-advance
kernels) against the dense FP32 ``beam_search``; ``vs_baseline`` is their
ratio. ``--engine``: the ``TranslationEngine``'s tokens/s at full
occupancy, the same-process offline search, and occupancy under churn at
0.9 offered load. ``--train``: images or tokens/s of the 4-bit STE KD step
against the FP32 step of the same student.

Timing is ``bench.py``'s: a chain of n units of work (searches or train
steps) between two host syncs, each unit's result fed to the next, and a
two-point estimate (the median over ``--trials`` of the differences between
the ``--hi`` and ``--lo`` chains, ``(t_hi - t_lo) / (hi - lo)``), so the
fixed cost of a chain cancels. A search is one replay of the CUDA graph the
search captured at its first call (``serve.beam.SEARCH_GRAPHS``), the
counterpart of JAX's ``while_loop`` over a jitted search; its tokens, clipped
to [4, V - 1], are the next search's source and its scores are summed on the
device, read back once at the end. A train chain runs n graphed
``make_train_step(donate=True)`` steps in place on a state that the bench
owns, reset from a pristine copy at the start of each chain (a fixed cost
that cancels), with the losses summed on the device: as JAX's
``while_loop`` carries its state, nothing is copied between steps.

One deliberate change from ``bench.py``: the two legs of a ratio (packed
and FP32 serving, 4-bit and FP32 train) are timed in turns in one process,
one trial of each in alternation, because host-clock rates on the card's
machine spread by a third to a half between calls. TF32 is off throughout,
so the FP32 legs (the dense search, the FP32 step, the encoder) run in true
f32, as ``chip_smoke.py`` runs them.

``--engine``'s ``vs_offline_same_process`` keeps ``bench.py``'s meaning: a
decode-only engine step (admission and encoding are outside the timed
chunks) against an offline search that pays for its encoder; it is not a
like-for-like ratio of decode cost.

``--train --family seq2seq`` on the card without ``--quick`` writes
``bench.py``'s flagship record (the 4-bit and FP32 step seconds, the
gradient payload) with the card's name and power limit to
``bench_flagship_train_torch.json`` at the repository root, which
``graft_entry --step-from`` reads. ``bench.py``'s own file is never read or
written. ``bench.py``'s generator knobs tune the TPU kernel: the port
accepts their defaults and rejects any other value.

Weights come from the port's seeded init (the served model and the
teachers seed 0, the train students seed 1)
and inputs from NumPy seeded generators, unless a builder is handed
flax-layout ``params`` and inputs (the CPU tests hand it ``bench.py``'s own).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from ._device import resolve_device
from .config import BeamConfig, DistillSpec, QuantSpec, ServeConfig, TrainConfig
from .convert import params_to_numpy
from .kernels.topk_fused import pick_generator_group
from .models import make_lm, make_seq2seq, make_wrn
from .serve import TranslationEngine, beam_search, beam_search_packed, pack_decoder
from .train import (
    build_optimizer,
    create_train_state,
    lm_task,
    make_train_step,
    nmt_task,
    vision_task,
)
from .train.trainer import _clone_state, _copy_into, _state_tensors
from .utils.profiling import card_line

SERVE_METRIC = "wmt13_student_4bit_beam_decode_tokens_per_s_per_chip"
ENGINE_METRIC = "engine_continuous_batching_tokens_per_s_per_chip"
TRAIN_METRICS = {
    "wrn": ("wrn2810_kd_4bit_ste_train_images_per_s_per_chip", "images/s"),
    "lm": ("ptb_lm_2x650_kd_4bit_ste_train_tokens_per_s_per_chip", "tokens/s"),
    "seq2seq": ("wmt13_kd_4bit_ste_train_tokens_per_s_per_chip", "tokens/s"),
}
FLAGSHIP_FILE = Path(__file__).resolve().parent.parent / "bench_flagship_train_torch.json"
# bench.py's generator knobs and their defaults: the only values accepted
GEN_KNOBS = {"gen_store_bits": 0, "gen_group": 0, "gen_lse_shift": 1, "no_gen_fold": False,
             "gen_pair": 0}
SEED = 0  # sources, batches and the teacher's weights; the student's is SEED + 1
TRAIN_RNG = 1  # the train steps' seed, bench.py's PRNGKey(1)


def sources(args) -> np.ndarray:
    """The serving sources: ``batch`` sentences of ``src_len`` tokens in [4, V)."""
    return np.random.default_rng(SEED).integers(4, args.vocab, (args.batch, args.src_len))


def chain(search: Callable, src, src_len, vocab: int) -> Callable[[int], tuple]:
    """``run(n)`` → (the scores of ``n`` chained searches summed on the
    device, the last search's tokens clipped to [4, V - 1]): each search's
    clipped tokens are the next one's source (``bench.py:62-75``)."""

    def run(n: int):
        s, acc = src, torch.zeros((), dtype=torch.float32, device=src.device)
        for _ in range(n):
            toks, scores = search(s, src_len)
            s = toks.clamp(4, vocab - 1)
            acc = acc + scores.sum()
        return acc, s

    return run


def _tokens(arr, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(arr), dtype=torch.int64, device=dev)


def _seq2seq(args, dev, params):
    """The serving model: ``params`` (a flax-layout tree) loaded, else the
    seeded init."""
    model = make_seq2seq(args.preset, args.vocab, args.vocab, device=dev, seed=SEED)
    return model if params is None else model.load_params(params)


def _packed(args, model, params, rows: int):
    """The 4-bit serving decoder: bf16 compute, the generator group of
    ``rows`` decode rows."""
    return pack_decoder(params_to_numpy(model) if params is None else params, model.cfg,
                        args.bits, compute_dtype=torch.bfloat16,
                        generator_group=pick_generator_group(rows), device=model.device)


def build(args, params=None, src=None):
    """→ ``(fp_loop, q_loop)``: ``loop(n)`` is the scores of ``n`` chained
    dense FP32 / packed 4-bit searches summed on the device (``bench.py``'s
    ``build``). ``params`` (a flax-layout tree) and ``src`` ([B, L] ints)
    replace the seeded weights and sources."""
    dev = resolve_device(args.device)
    model = _seq2seq(args, dev, params)
    dec = _packed(args, model, params, args.batch * args.beam)
    src = _tokens(sources(args) if src is None else src, dev)
    src_len = torch.full((args.batch,), args.src_len, dtype=torch.int64, device=dev)
    cfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    fp = chain(lambda s, sl: beam_search(model, s, sl, cfg, device=dev), src, src_len, args.vocab)
    q = chain(lambda s, sl: beam_search_packed(model, dec, s, sl, cfg, device=dev), src,
              src_len, args.vocab)
    return (lambda n: fp(n)[0]), (lambda n: q(n)[0])


def time_paths(legs: Dict[str, Callable[[int], torch.Tensor]], lo: int, hi: int,
               trials: int) -> Dict[str, float]:
    """Seconds per unit of chained work of each leg (``leg(n)`` runs n units
    and returns a device scalar, read back to sync): ``bench.py``'s
    ``time_path`` two-point estimate, the legs timed in turns, one trial of
    each, the order reversed every other trial."""
    names = list(legs)
    for name in names:  # warm: the first calls capture the graphs
        for n in (lo, hi):
            _finite(float(legs[name](n)), name)
    samples = {name: {lo: [], hi: []} for name in names}
    for i in range(trials):
        for name in (names if i % 2 == 0 else names[::-1]):
            for n in (lo, hi):
                t0 = time.perf_counter()
                acc = float(legs[name](n))
                samples[name][n].append(time.perf_counter() - t0)
                _finite(acc, name)
    out = {}
    for name, s in samples.items():
        ests = sorted((h - l) / (hi - lo) for h, l in zip(sorted(s[hi]), sorted(s[lo])))
        out[name] = max(ests[len(ests) // 2], 1e-9)
    return out


def _finite(x: float, what: str) -> None:
    if not np.isfinite(x):
        raise RuntimeError(f"{what}: non-finite chain result {x}")


@dataclasses.dataclass
class TrainLegs:
    """``build_train``'s legs: ``q_loop(n)`` / ``fp_loop(n)`` sum the losses
    of n chained 4-bit / FP32 steps on the device; ``n_items`` is a step's
    images or tokens, ``grad_payload`` the student's f32 gradient bytes;
    ``student`` and ``batch`` are the models' and steps' inputs as built."""

    q_loop: Callable[[int], torch.Tensor]
    fp_loop: Callable[[int], torch.Tensor]
    n_items: int
    grad_payload: int
    student: torch.nn.Module
    batch: Dict[str, torch.Tensor]


def _load(model, variables):
    """``variables`` (flax ``{"params", "batch_stats"}``) into ``model``."""
    if variables is not None:
        model.load_params(variables["params"])
        if "batch_stats" in variables:
            model.load_batch_stats(variables["batch_stats"])
    return model


def build_train(args, params=None, batch=None) -> TrainLegs:
    """The 4-bit STE and FP32 KD train legs (``bench.py``'s ``build_train``):
    ``--family seq2seq``: teacher 2x500 → ``--preset`` at dropout 0 on a
    WMT-shaped batch; ``wrn``: WRN-28-10 → WRN ``student_medium`` on
    CIFAR-100-shaped images; ``lm``: the 2x650 PTB LM → ``student_medium``
    at V 10000, bptt 35 (``--quick``: small presets at ``--vocab`` and
    ``--src-len``). Adam lr 1e-3, clip 5.0, ``DistillSpec()``. ``params``
    (``{"teacher": variables, "student": variables}``, flax layout) and
    ``batch`` (the step's arrays) replace the seeded ones."""
    dev = resolve_device(args.device)
    params = params or {}
    rng = np.random.default_rng(SEED)
    b, l = args.batch, args.src_len
    if args.family == "wrn":
        teacher = make_wrn("teacher" if not args.quick else "student_small", num_classes=100,
                           device=dev, seed=SEED)
        student = make_wrn("student_medium" if not args.quick else "student_small",
                           num_classes=100, device=dev, seed=SEED + 1)
        batch = batch or {"image": rng.standard_normal((b, 32, 32, 3), dtype=np.float32),
                          "label": rng.integers(0, 100, b)}
        task_fn, n_items = vision_task, b
    elif args.family == "lm":
        vocab = 10000 if not args.quick else args.vocab  # PTB vocab
        bptt = 35 if not args.quick else l
        teacher = make_lm("teacher", vocab, device=dev, seed=SEED)  # Zaremba 2x650
        student = make_lm("student_small" if args.quick else "student_medium", vocab,
                          device=dev, seed=SEED + 1)
        batch = batch or {"input": rng.integers(0, vocab, (b, bptt)),
                          "target": rng.integers(0, vocab, (b, bptt))}
        task_fn, n_items = lm_task, b * bptt
    else:
        teacher = make_seq2seq("teacher", args.vocab, args.vocab, dropout=0.0, device=dev,
                               seed=SEED)
        student = make_seq2seq(args.preset, args.vocab, args.vocab, dropout=0.0, device=dev,
                               seed=SEED + 1)
        batch = batch or {"src": rng.integers(4, args.vocab, (b, l)),
                          "src_len": np.full((b,), l),
                          "tgt_in": rng.integers(4, args.vocab, (b, l)),
                          "tgt_out": rng.integers(4, args.vocab, (b, l)),
                          "tgt_mask": np.ones((b, l), np.float32)}
        task_fn, n_items = nmt_task, b * l
    _load(teacher, params.get("teacher"))
    _load(student, params.get("student"))
    task = task_fn(student, teacher, device=dev)
    batch = {k: torch.tensor(np.asarray(v), device=dev, dtype=(
        torch.float32 if np.asarray(v).dtype.kind == "f" else torch.int64))
        for k, v in batch.items()}
    tx = build_optimizer(TrainConfig(learning_rate=1e-3, clip_norm=5.0))

    def make_loop(quant):
        step = make_train_step(task, tx, quant=quant, distill=DistillSpec(), donate=True,
                               device=dev)
        # the leg's own copies of the weights and statistics: pristine, and
        # the working state the steps update in place
        state0 = create_train_state(
            {n: p.detach().clone() for n, p in student.named_parameters()}, tx,
            batch_stats={n: t.clone() for n, t in student.named_buffers()} or None,
            device=dev)
        work = _clone_state(state0)

        def loop(n: int) -> torch.Tensor:
            _copy_into(_state_tensors(work), _state_tensors(state0))
            st = work.replace(step=0, opt_state=work.opt_state._replace(count=0))
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(n):
                st, metrics = step(st, batch, TRAIN_RNG)
                acc = acc + metrics["loss"]
            return acc

        return loop

    grad_payload = 4 * sum(p.numel() for p in student.parameters())
    return TrainLegs(make_loop(QuantSpec(bits=args.bits)), make_loop(None), n_items,
                     grad_payload, student, batch)


def run_train(args) -> dict:
    """``--train``: prints and returns ``bench.py``'s train line; writes the
    flagship record on the card for ``--family seq2seq`` without
    ``--quick``."""
    legs = build_train(args)
    t = time_paths({"q": legs.q_loop, "fp": legs.fp_loop}, args.lo, args.hi, args.trials)
    t_q, t_fp = t["q"], t["fp"]
    name, unit = TRAIN_METRICS[args.family]
    if args.family == "seq2seq" and not args.quick and resolve_device(args.device).type == "cuda":
        record = {
            "workload": "wmt13_kd_4bit_ste_train (teacher 2x500 -> "
                        f"{args.preset}, B={args.batch}, L={args.src_len}, V={args.vocab})",
            "device": torch.cuda.get_device_name(),
            "card": card_line(),
            "train_step_seconds": t_q,
            "fp32_step_seconds": t_fp,
            "grad_payload_f32_bytes": legs.grad_payload,
            "written_by": "python -m quantized_distillation_tpu_torch.bench --train "
                          "--family seq2seq",
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        FLAGSHIP_FILE.write_text(json.dumps(record, indent=1))
    return _print({"metric": name, "value": round(legs.n_items / t_q, 1), "unit": unit,
                   "vs_baseline": round(t_fp / t_q, 3)})


def run_engine(args, params=None, src=None) -> dict:
    """``--engine`` (``bench.py``'s ``run_engine``): the engine's tokens/s
    at full occupancy from a two-point estimate over the chunk length
    (``drive_chunks``: chunks replayed with no readback between them; t_step
    = Δwall / (iters · Δchunk)), the offline packed search in the same
    process, then churn: ``3 S`` requests arriving at 0.9 offered load
    (``--arrival`` poisson or smooth), occupancy, steady-state occupancy and
    the idle attributions. Prints and returns the line. ``params`` and
    ``src`` (the offline leg's sources) replace the seeded ones; the
    sentences and arrivals come from ``np.random.default_rng(0)`` as in
    ``bench.py``."""
    dev = resolve_device(args.device)
    model = _seq2seq(args, dev, params)
    s_slots = args.batch
    dec = _packed(args, model, params, s_slots * args.beam)
    nprng = np.random.default_rng(0)
    sents = [list(nprng.integers(4, args.vocab, args.src_len)) for _ in range(s_slots)]

    lo_c, hi_c, iters = (1, 3, 2) if args.quick else (4, 32, 6)
    t_big = 64 if args.quick else args.t_max
    cfg = ServeConfig(max_slots=s_slots, max_src_len=args.src_len, max_tgt_len=t_big,
                      beam=BeamConfig(beam_size=args.beam, max_len=t_big), admit_batch=16,
                      chunk_steps=lo_c)
    eng = TranslationEngine(model, cfg, dec, device=dev)
    for s in sents:
        eng.submit(s)
    eng.step()  # admit + warm
    walls = {}
    for chunk in (lo_c, hi_c):
        _emitted(eng.drive_chunks(1, chunk_steps=chunk))  # warm + sync
        samples = []
        for _ in range(args.trials):
            t0 = time.perf_counter()
            _emitted(eng.drive_chunks(iters, chunk_steps=chunk))  # one readback
            samples.append(time.perf_counter() - t0)
        walls[chunk] = sorted(samples)[len(samples) // 2]
    t_step = max((walls[hi_c] - walls[lo_c]) / (iters * (hi_c - lo_c)), 1e-9)
    engine_tok_s = s_slots / t_step
    del eng

    # the offline leg in the same process, on the engine's model and decoder
    ocfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    src0 = _tokens(sources(args) if src is None else src, dev)
    src_len = torch.full((s_slots,), args.src_len, dtype=torch.int64, device=dev)
    o_loop = chain(lambda s, sl: beam_search_packed(model, dec, s, sl, ocfg, device=dev), src0,
                   src_len, args.vocab)
    lo_n, hi_n = (1, 2) if args.quick else (4, 36)
    t_dec = time_paths({"offline": lambda n: o_loop(n)[0]}, lo_n, hi_n, args.trials)["offline"]
    offline_tok_s = s_slots * args.src_len / t_dec

    churn = _churn(args, model, dec, sents, nprng, dev)
    return _print({
        "metric": ENGINE_METRIC,
        "value": round(engine_tok_s, 1),
        "unit": "tokens/s",
        # against the default mode's offline number, passed as --offline-tok-s
        "vs_baseline": (round(engine_tok_s / args.offline_tok_s, 3)
                        if args.offline_tok_s else None),
        "offline_same_process_tokens_per_s": round(offline_tok_s, 1),
        # decode-only engine step vs an offline search that pays its encoder
        "vs_offline_same_process": round(engine_tok_s / offline_tok_s, 3),
        **churn,
    })


def _emitted(n: int) -> None:
    if n <= 0:
        raise RuntimeError("a full-occupancy engine chunk emitted no token")


def _churn(args, model, dec, sents, nprng, dev) -> dict:
    """``bench.py``'s churn segment on a fresh engine: arrivals at 0.9
    offered load, run until every request completes → its fields of the
    line."""
    s_slots = args.batch
    t_churn = 16 if args.quick else 64
    cfg = ServeConfig(
        max_slots=s_slots, max_src_len=args.src_len, max_tgt_len=t_churn,
        beam=BeamConfig(beam_size=args.beam, max_len=t_churn), admit_batch=16,
        chunk_steps=1 if args.quick else 4,
        # while requests queue, 1-step chunks re-admit freed slots at once
        chunk_steps_busy=None if args.quick else 1,
        stage_ahead=args.stage_ahead,
    )
    eng = TranslationEngine(model, cfg, dec, device=dev)
    n_req = 3 * s_slots
    # per chunk the grid retires ~slots * chunk_steps tokens; at 0.9 load
    # the arrivals a chunk are 0.9 * slots * chunk_steps / decode length
    lam = 0.9 * s_slots * cfg.chunk_steps / t_churn
    if args.arrival == "smooth":
        acc = np.cumsum(np.full(10 * n_req, lam))
        arrivals = np.diff(np.floor(acc), prepend=0.0).astype(np.int64)
    else:
        arrivals = nprng.poisson(lam, size=10 * n_req)
    submitted = completed = it = 0
    # the steady-state window runs from the first completion until the
    # submissions run out (no ramp-up, no drain tail)
    ss_start = ss_end = None
    # idle slot-steps with an empty queue (offered-load variance) and those
    # stranded mid-chunk by completions (estimated)
    idle_queue_empty = idle_midchunk = 0
    while completed < n_req:
        if submitted < n_req:
            for _ in range(int(arrivals[min(it, len(arrivals) - 1)])):
                if submitted < n_req:
                    eng.submit(sents[submitted % s_slots])
                    submitted += 1
            if submitted >= n_req and ss_end is None:
                ss_end = (eng.steps_run, eng.tokens_emitted)
        if eng.pending or eng.active_slots:
            pend_before, act_before = eng.pending, eng.active_slots
            admitted = min(pend_before, s_slots - act_before)
            steps_before = eng.steps_run
            done = eng.step()
            chunk_len = eng.steps_run - steps_before
            idle_queue_empty += (s_slots - act_before - admitted) * chunk_len
            idle_midchunk += len(done) * max(chunk_len - 1, 0) // 2
            completed += len(done)
        if completed and ss_start is None:
            ss_start = (eng.steps_run, eng.tokens_emitted)
        it += 1
        if it >= 100000:
            raise RuntimeError(f"churn: {completed} of {n_req} requests after {it} rounds")
    occupancy = eng.tokens_emitted / max(eng.steps_run * s_slots, 1)
    if ss_start and ss_end and ss_end[0] > ss_start[0]:
        ss_occ = (ss_end[1] - ss_start[1]) / ((ss_end[0] - ss_start[0]) * s_slots)
    else:
        ss_occ = occupancy
    denom = max(eng.steps_run * s_slots, 1)
    return {
        "occupancy_at_0.9_load": round(float(occupancy), 3),
        "steady_state_occupancy": round(float(ss_occ), 3),
        "offered_load": 0.9,
        "arrival": args.arrival,
        "stage_ahead": args.stage_ahead,
        "requests_churned": n_req,
        "idle_frac_queue_empty": round(idle_queue_empty / denom, 3),
        "idle_frac_midchunk_est": round(idle_midchunk / denom, 3),
    }


def run_serve(args) -> dict:
    """The default mode: prints and returns ``bench.py``'s serving line."""
    fp_loop, q_loop = build(args)
    t = time_paths({"q": q_loop, "fp": fp_loop}, args.lo, args.hi, args.trials)
    tokens = args.batch * args.src_len
    tok_s_q, tok_s_fp = tokens / t["q"], tokens / t["fp"]
    return _print({"metric": SERVE_METRIC, "value": round(tok_s_q, 1), "unit": "tokens/s",
                   "vs_baseline": round(tok_s_q / tok_s_fp, 3)})


def _print(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


@contextlib.contextmanager
def true_f32():
    """TF32 off for CUDA matmuls and cuDNN inside the block (restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; the default) or cpu (the tests' plain versions)")
    p.add_argument("--preset", default="student_medium")
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--src-len", type=int, default=24)
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--lo", type=int, default=None,
                   help="short-chain length (default 4 searches, 2 train steps)")
    p.add_argument("--hi", type=int, default=None,
                   help="long-chain length (default 36 searches, 8 train steps)")
    p.add_argument("--quick", action="store_true", help="tiny shapes")
    p.add_argument("--train", action="store_true",
                   help="bench the 4-bit STE KD train step instead of serving decode")
    p.add_argument("--family", default="seq2seq", choices=("seq2seq", "wrn", "lm"),
                   help="--train model family (wrn = full WRN-28-10 teacher, "
                   "lm = the 2x650 PTB LSTM teacher)")
    p.add_argument("--engine", action="store_true",
                   help="bench the continuous-batching engine (throughput + churn)")
    p.add_argument("--gen-store-bits", type=int, default=0,
                   help="bench.py's TPU generator knob: only its default 0 is accepted")
    p.add_argument("--gen-group", type=int, default=0,
                   help="bench.py's TPU generator knob: only its default 0 is accepted")
    p.add_argument("--gen-lse-shift", type=int, default=1,
                   help="bench.py's TPU generator knob: only its default 1 is accepted")
    p.add_argument("--no-gen-fold", action="store_true",
                   help="bench.py's TPU generator knob: not accepted")
    p.add_argument("--gen-pair", type=int, default=0,
                   help="bench.py's TPU generator knob: only its default 0 is accepted")
    p.add_argument("--arrival", default="poisson", choices=("poisson", "smooth"),
                   help="--engine churn arrival process: bursty Poisson (default) or "
                   "deterministic smoothed at the same 0.9 offered load")
    p.add_argument("--stage-ahead", type=int, default=2,
                   help="--engine admit-ahead staging depth (pre-encoded admission batches; "
                   "0 = off)")
    p.add_argument("--t-max", type=int, default=256,
                   help="--engine grid target-length cap at full occupancy")
    p.add_argument("--offline-tok-s", type=float, default=0.0,
                   help="offline beam tokens/s (default-mode output) for --engine's "
                   "vs_baseline ratio")
    args = p.parse_args(argv)
    for knob, default in GEN_KNOBS.items():
        if getattr(args, knob) != default:
            p.error(f"--{knob.replace('_', '-')} tunes the TPU generator kernel; the port's "
                    f"generator has no such knob (only the default {default} is accepted)")
    if args.quick:
        args.vocab, args.batch, args.src_len = 512, 8, 8
        args.trials, args.lo, args.hi = 2, 1, 3
    # train steps are ~100x a decode step: shorter chains suffice
    args.lo = args.lo or (2 if args.train else 4)
    args.hi = args.hi or (8 if args.train else 36)
    return args


def main(argv=None) -> dict:
    """Run the mode ``argv`` asks for; prints its one JSON line and returns
    it."""
    args = parse_args(argv)
    resolve_device(args.device)  # raises without a card unless --device cpu
    with true_f32():
        if args.engine:
            return run_engine(args)
        if args.train:
            return run_train(args)
        return run_serve(args)


if __name__ == "__main__":
    main()
