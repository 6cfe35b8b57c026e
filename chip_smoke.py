#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, count and ``nvidia-smi`` power limit; exits
   non-zero without a result when PyTorch sees no card;
2. build: compiles the four CUDA kernels from ``csrc/`` (one ``nvcc`` each,
   in parallel) and reports the seconds and ``ptxas`` resource lines;
3. kernels: calls each serving kernel's wrapper at the shapes the serving
   main path gives it (student_medium, V=32000, B=256 x beam 5 = 1280 rows,
   4-bit), holds it against its plain PyTorch version on the same inputs,
   and times kernel, plain version and a one-call PyTorch yardstick with
   CUDA events;
4. main path: ``pack_decoder`` → ``beam_search_packed`` at full width (depth
   as published: 2 layers), checks the launch counters (3 dequant-matmul,
   1 fused top-k, 1 combine per decode step), finite scores, and f32 tokens
   equal to the port's CPU plain path on 16 sentences; then times the packed
   bf16 path and the dense FP32 ``beam_search`` on the card;
5. profile: device time by kernel over one packed beam search
   (``torch.profiler``) and the device's busy share of that run;
6. train kernel: the fake-quant kernel at the train step's shape (every
   quantizable leaf of student_medium: 105,984 buckets x 256), bit-exact
   against its plain version for 2/4/8 bits x linear/abs-max and on
   constant and zero buckets, timed against the plain version;
7. train path: 4-bit STE knowledge distillation of student_medium from the
   2x500 teacher at ``bench.py --train --family seq2seq``'s shape (V=32000,
   B=128, L=24, Adam 1e-3, clip 5, KD w=0.7 T=5): ``nmt_task`` →
   ``create_train_state`` → ``make_train_step`` for 10 steps on one batch,
   then ``make_eval_step``; checks one fake-quant launch per step (and one
   for the eval step), finite loss and gradient norm, a falling loss, and
   one step at B=8 on the card against the port's CPU plain path from the
   same weights; then times the 4-bit and the FP32 step;
8. train profile: device time by kernel over one 4-bit step and the
   fake-quant kernel's share of it.

Then the kernel table as one JSON object, then the result line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. Weights are random, made from a seed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from quantized_distillation_tpu_torch.config import (
    BeamConfig,
    DistillSpec,
    QuantSpec,
    TrainConfig,
)
from quantized_distillation_tpu_torch.convert import flax_leaves, params_to_numpy
from quantized_distillation_tpu_torch.kernels import (
    _build,
    beam_combine_topk,
    beam_combine_topk_reference,
    dequant_matmul,
    dequant_matmul_reference,
    dequant_matmul_topk,
    dequant_matmul_topk_reference,
    dequantize_linear,
    fake_quant_buckets,
    fake_quant_buckets_reference,
    pack_linear,
    pick_generator_group,
)
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.ops.bucketing import to_buckets
from quantized_distillation_tpu_torch.serve import beam_search, beam_search_packed, pack_decoder
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
    nmt_task,
)
from quantized_distillation_tpu_torch.train.quantize_tree import is_quantizable
from quantized_distillation_tpu_torch.train.optim import apply_updates, global_norm
from quantized_distillation_tpu_torch.train.trainer import (
    as_batch,
    loss_and_grads,
    quantized_params,
)

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores (NVIDIA data sheet)
HBM = 3.35e12  # H100 SXM device memory, bytes/s
F32_TOL = 1e-4  # rtol = atol, as tests/test_kernels.py states for f32 compute
# train-step parity, as tests/test_torch_train.py states it for f32: loss and
# metrics rtol 1e-5; gradients within 1e-4 of the tensor's largest |gradient|;
# updated weights rtol 1e-5, atol 1e-6
LOSS_RTOL, GRAD_TOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-5, 1e-6
BF16_REL = 2e-2  # bf16 values: relative to the row's largest |value|
BF16_TIE = 4 * 2.0 ** -8  # bf16 tie band (TestCrossKernelNumerics), times max(|logit|, 1)

SRC = "quantized_distillation_tpu_torch/csrc/"
JAXK = "quantized_distillation_tpu/kernels/"
COUNTERS = (dequant_matmul, dequant_matmul_topk, beam_combine_topk, fake_quant_buckets)


def zero_counts() -> None:
    for c in COUNTERS:
        c.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {c.__name__: c.launches for c in COUNTERS}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Checks:
    """Collects failed checks; any failure makes the run exit non-zero."""

    def __init__(self):
        self.failed = []

    def require(self, ok: bool, what: str) -> bool:
        if not ok:
            self.failed.append(what)
            print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
        return ok


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """(least ms the card could take, what bounds it): the larger of the
    operations at ``peak`` (the bf16 tensor-core rate unless given) and the
    bytes at the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def packed_bytes(p) -> int:
    return nbytes(p.packed, p.scale, p.offset, p.bias)


def phase_device():
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    emit({"phase": "device", **dev, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return dev, smi


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = [
        f"{name}: {line.split('ptxas info    : ')[-1]}"
        for name, log in logs.items()
        for line in log.splitlines()
        if "registers" in line
    ]
    emit({"phase": "build", "seconds": round(secs, 2), "built": sorted(logs), "ptxas": ptxas})


def check_values(checks, name, got, want, cd):
    """f32: |got - want| <= tol * (1 + |want|); bf16: within BF16_REL of the
    row's largest |want|. Returns the max abs error."""
    err = (got - want).abs()
    if cd == torch.float32:
        ok = bool((err <= F32_TOL * (1 + want.abs())).all())
    else:
        scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
        ok = bool((err <= BF16_REL * scale).all())
    checks.require(ok, f"{name}: values outside tolerance (max abs err {float(err.max())})")
    return float(err.max())


def check_topk_indices(checks, name, v, i, rv, ri, cd):
    """Index lists equal, except where the disagreeing values lie within the
    tie band of the compute type. Returns (rows equal, rows in the band)."""
    rows_equal = (i == ri).all(dim=1)
    scale = rv.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    band = (BF16_TIE if cd == torch.bfloat16 else F32_TOL) * scale
    in_band = ((v - rv).abs() <= band).all(dim=1) & ~rows_equal
    ok = bool((rows_equal | in_band).all())
    checks.require(ok, f"{name}: top-k indices differ outside the tie band")
    return int(rows_equal.sum()), int(in_band.sum())


def phase_kernels(checks, dec, rows, gen):
    """Each kernel at the main path's shapes against its plain version."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    table = []

    # --- dequant_matmul: the two fused LSTM-gate matrices and attn_out
    dm = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0, flops=0.0, bytes=0.0)
    shapes = []
    for name, p, xdt in (
        ("lstm_0", dec.cells[0].w, bf16),  # [x_emb; feed; h] arrives in bf16
        ("lstm_1", dec.cells[1].w, bf16),
        ("attn_out", dec.attn_out, torch.float32),  # [context f32; h]
    ):
        k, n = p.shape
        x = torch.randn(rows, k, generator=gen).to(dev, xdt)
        for cd in (torch.float32, bf16):
            got = dequant_matmul(x, p, compute_dtype=cd)
            want = dequant_matmul_reference(x, p, compute_dtype=cd)
            err = check_values(checks, f"dequant_matmul/{name}/{cd}", got, want, cd)
            if cd == bf16:
                dm["err"] = max(dm["err"], err)
        w16 = dequantize_linear(p, bf16)
        ms = cuda_ms(lambda: dequant_matmul(x, p, compute_dtype=bf16))
        plain = cuda_ms(lambda: dequant_matmul_reference(x, p, compute_dtype=bf16))
        lib = cuda_ms(lambda: torch.matmul(x.to(bf16), w16))
        flops = 2.0 * rows * k * n
        byt = nbytes(x) + packed_bytes(p) + rows * n * 4
        bms, _ = bound(flops, byt)
        shapes.append({"name": name, "M": rows, "K": k, "N": n, "x": str(xdt), "ms": ms,
                       "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
                       "flops": flops, "bytes": byt})
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bms), ("flops", flops), ("bytes", byt)):
            dm[key] += val
    _, by = bound(dm["flops"], dm["bytes"])
    emit({"phase": "kernel", "name": "dequant_matmul", "per_shape": shapes,
          "per_step": {"flops": dm["flops"], "bytes": dm["bytes"]}})
    table.append({
        "name": "dequant_matmul", "route": "cuda", "source": SRC + "dequant_matmul.cu",
        "replaces": JAXK + "dequant_matmul.py:68", "max_abs_err": dm["err"],
        "ms": dm["ms"], "plain_ms": dm["plain_ms"], "bound_ms": dm["bound_ms"],
        "bound_by": by, "library_ms": dm["library_ms"],
        "per": "one decode step: lstm_0 + lstm_1 + attn_out",
    })

    # --- fused generator top-k
    g = dec.generator
    k_top = 5
    x = torch.randn(rows, g.shape[0], generator=gen).to(dev)
    stats = {}
    for cd in (torch.float32, bf16):
        v, i, lse = dequant_matmul_topk(x, g, k_top, compute_dtype=cd)
        rv, ri, rlse = dequant_matmul_topk_reference(x, g, k_top, compute_dtype=cd)
        err = max(check_values(checks, f"topk/{cd}/values", v, rv, cd),
                  check_values(checks, f"topk/{cd}/lse", lse, rlse, cd))
        eq, band = check_topk_indices(checks, f"topk/{cd}", v, i, rv, ri, cd)
        stats[str(cd)] = {"max_abs_err": err, "rows_equal": eq, "rows_in_tie_band": band}
    # tie-heavy: zero weights make the logits the bias exactly, full of ties
    tie_bias = torch.randint(0, 4, (g.shape[1],), generator=gen).float()
    gt = pack_linear(torch.zeros(g.shape), 4, bias=tie_bias, max_group=g.group).to(dev)
    v, i, _ = dequant_matmul_topk(x, gt, k_top, compute_dtype=bf16)
    rv, ri, _ = dequant_matmul_topk_reference(x, gt, k_top, compute_dtype=bf16)
    checks.require(torch.equal(i, ri) and torch.equal(v, rv), "topk/ties: not exact")
    stats["ties"] = {"rows_equal": int((i == ri).all(dim=1).sum())}
    g16 = dequantize_linear(g, bf16)
    bias = g.bias

    def library():
        logits = torch.matmul(x.to(bf16), g16).float() + bias
        return torch.topk(logits, k_top), torch.logsumexp(logits, dim=-1)

    ms = cuda_ms(lambda: dequant_matmul_topk(x, g, k_top, compute_dtype=bf16))
    plain = cuda_ms(lambda: dequant_matmul_topk_reference(x, g, k_top, compute_dtype=bf16), iters=5)
    lib = cuda_ms(library)
    flops = 2.0 * rows * g.shape[0] * g.shape[1]
    byt = nbytes(x) + packed_bytes(g) + rows * (k_top * 8 + 4)
    bms, by = bound(flops, byt)
    emit({"phase": "kernel", "name": "dequant_matmul_topk", "M": rows, "K": g.shape[0],
          "N": g.shape[1], "k": k_top, "checks": stats, "flops": flops, "bytes": byt})
    table.append({
        "name": "dequant_matmul_topk", "route": "cuda", "source": SRC + "topk_fused.cu",
        "replaces": JAXK + "topk_fused.py:78", "max_abs_err": stats[str(bf16)]["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
    })

    # --- beam combine: [B, beam * kc] candidates as the beam core builds them
    b = rows // k_top
    n = k_top * k_top
    cand = torch.randn(b, n, generator=gen) * 10
    cand[torch.rand(b, n, generator=gen) < 0.3] = -1e9  # finished-beam blocks
    cand[:, 3] = cand[:, 7]  # exact ties
    cand = cand.to(dev)
    tok = torch.randint(0, 32000, (b, n), generator=gen, dtype=torch.int32).to(dev)
    got = beam_combine_topk(cand, tok, k_top)
    want = beam_combine_topk_reference(cand, tok, k_top)
    exact = all(torch.equal(a, c) for a, c in zip(got, want))
    checks.require(exact, "beam_combine: not bit-exact")
    ms = cuda_ms(lambda: beam_combine_topk(cand, tok, k_top), iters=100)
    plain = cuda_ms(lambda: beam_combine_topk_reference(cand, tok, k_top), iters=100)
    lib = cuda_ms(lambda: torch.topk(cand, k_top), iters=100)
    flops, byt = float(b * n * k_top), nbytes(cand, tok) + b * k_top * 12
    bms, by = bound(flops, byt)
    emit({"phase": "kernel", "name": "beam_combine_topk", "B": b, "n": n, "k": k_top,
          "bit_exact": exact, "flops": flops, "bytes": byt})
    table.append({
        "name": "beam_combine_topk", "route": "cuda", "source": SRC + "beam_combine.cu",
        "replaces": JAXK + "beam_combine.py:41",
        "max_abs_err": float((got[0] - want[0]).abs().max()),
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
    })
    return table


def timed_runs(fn, reps: int):
    """Host seconds of ``reps`` synchronized calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase_main_path(checks, args, model, params, smi):
    dev = torch.device("cuda")
    cfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    gen = torch.Generator().manual_seed(args.seed + 1)
    src = torch.randint(4, args.vocab, (args.batch, args.src_len), generator=gen)
    src_len = torch.full((args.batch,), args.src_len, dtype=torch.int64)
    group = pick_generator_group(args.batch * args.beam)
    dec = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.bfloat16,
                       generator_group=group, device=dev)

    zero_counts()
    toks, scores = beam_search_packed(model, dec, src, src_len, cfg, device=dev)
    launches = read_counts()
    steps = cfg.max_len
    want = {"dequant_matmul": 3 * steps, "dequant_matmul_topk": steps, "beam_combine_topk": steps,
            "fake_quant_buckets": 0}
    checks.require(launches == want, f"main path launches {launches}, expected {want}")
    checks.require(tuple(toks.shape) == (args.batch, steps), f"tokens shape {tuple(toks.shape)}")
    checks.require(bool(torch.isfinite(scores).all()), "main path scores not finite")
    checks.require(bool(((toks >= 0) & (toks < args.vocab)).all()), "token ids out of range")

    # f32 tokens: the card's kernels against the CPU plain versions
    ns = args.cpu_sentences
    dec32 = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.float32,
                         generator_group=group, device=dev)
    g_toks, g_scores = beam_search_packed(model, dec32, src[:ns], src_len[:ns], cfg, device=dev)
    cpu_model = make_seq2seq(args.preset, args.vocab, args.vocab, device="cpu", seed=args.seed)
    dec_cpu = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.float32,
                           generator_group=group, device="cpu")
    c_toks, c_scores = beam_search_packed(cpu_model, dec_cpu, src[:ns], src_len[:ns], cfg,
                                          device="cpu")
    tok_equal = torch.equal(g_toks.cpu(), c_toks)
    checks.require(tok_equal, "f32 tokens on the card differ from the CPU plain path")
    score_err = float((g_scores.cpu() - c_scores).abs().max())

    # throughput: B * max_len tokens per beam search (encode included)
    t_packed = timed_runs(
        lambda: beam_search_packed(model, dec, src, src_len, cfg, device=dev), args.reps)
    t_dense = timed_runs(lambda: beam_search(model, src, src_len, cfg, device=dev), args.reps)
    ntok = args.batch * steps
    med_p, med_d = statistics.median(t_packed), statistics.median(t_dense)
    emit({
        "phase": "main_path", "preset": args.preset, "vocab": args.vocab, "batch": args.batch,
        "beam": args.beam, "max_len": steps, "bits": args.bits, "generator_group": group,
        "launches": launches, "f32_tokens_equal_cpu": tok_equal, "f32_sentences": ns,
        "f32_score_max_abs_diff": score_err,
        "packed_bf16_tokens_per_s": ntok / med_p, "packed_seconds": t_packed,
        "dense_fp32_tokens_per_s": ntok / med_d, "dense_seconds": t_dense,
        "card": smi,
    })
    phase_profile(lambda: beam_search_packed(model, dec, src, src_len, cfg, device=dev), med_p)
    return launches


def phase_profile(run, median_s: float, phase: str = "profile", focus: str = None) -> None:
    """Device time by kernel over one run (a packed beam search, a train
    step) under torch.profiler, and the device's busy share: of that run's
    host time (inflated by the profiler's own host overhead) and of the
    median unprofiled run. ``focus``: a kernel-name substring whose share of
    the device time is reported too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    device_ms = sum(ms for _, ms, _ in kernels)
    out = {
        "phase": phase, "wall_ms": wall * 1e3, "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        "device_busy_share_of_median_run": device_ms / (median_s * 1e3),
        "top": [{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in kernels[:12]],
    }
    if focus:
        focus_ms = sum(ms for k, ms, _ in kernels if focus in k)
        out.update(focus=focus, focus_ms=focus_ms, focus_share=focus_ms / max(device_ms, 1e-9))
    emit(out)


def quantizable_buckets(params, spec: QuantSpec) -> torch.Tensor:
    """Every quantizable flax leaf bucketed on its own and concatenated, as
    the train step hands them to the fake-quant kernel."""
    return torch.cat([
        to_buckets(leaf.detach().contiguous(), spec.bucket_size)[0]
        for path, leaf in flax_leaves(params) if is_quantizable(path, leaf, spec)
    ])


def phase_train_kernel(checks, student, gen) -> dict:
    """The fake-quant kernel at the train step's shape against its plain
    version: bit-exact, so the tolerance is 0."""
    buckets = quantizable_buckets(dict(student.named_parameters()), QuantSpec(bits=4))
    exact = {}
    for bits in (2, 4, 8):
        for scaling in ("linear", "absmax"):
            got = fake_quant_buckets(buckets, bits, scaling=scaling)
            want = fake_quant_buckets_reference(buckets, bits, scaling=scaling)
            exact[f"{bits}/{scaling}"] = ok = torch.equal(got, want)
            checks.require(ok, f"fake_quant {bits}-bit {scaling}: not bit-exact")
    flat = torch.cat([torch.full((64, 256), 3.25), torch.zeros(64, 256),
                      torch.randn(64, 256, generator=gen)]).cuda()
    for scaling in ("linear", "absmax"):
        got = fake_quant_buckets(flat, 4, scaling=scaling)
        ok = torch.equal(got, fake_quant_buckets_reference(flat, 4, scaling=scaling))
        exact[f"degenerate/{scaling}"] = ok
        checks.require(ok, f"fake_quant degenerate buckets {scaling}: not bit-exact")
    checks.require(torch.equal(fake_quant_buckets(flat[:128], 4), flat[:128]),
                   "fake_quant: constant or zero buckets changed")
    ms = cuda_ms(lambda: fake_quant_buckets(buckets, 4))
    plain = cuda_ms(lambda: fake_quant_buckets_reference(buckets, 4))
    n = buckets.numel()
    flops, byt = 8.0 * n, 2 * nbytes(buckets)
    bms, by = bound(flops, byt, PEAK_F32)
    emit({"phase": "kernel", "name": "fake_quant_buckets", "n_buckets": buckets.shape[0],
          "bucket_size": buckets.shape[1], "bit_exact": exact, "flops": flops, "bytes": byt,
          "achieved_bytes_per_s": byt / (ms * 1e-3)})
    return {
        "name": "fake_quant_buckets", "route": "cuda", "source": SRC + "fake_quant.cu",
        "replaces": JAXK + "fake_quant.py:39", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library": "no single PyTorch call computes bucketed min/max fake-quant",
    }


def kd_setup(args, device, batch_size, seed):
    """Student, its KD task from a fresh teacher, and a bench.py-shaped
    synthetic batch."""
    v, L = args.vocab, args.src_len
    teacher = make_seq2seq("teacher", v, v, dropout=0.0, device=device, seed=seed)
    student = make_seq2seq(args.preset, v, v, dropout=0.0, device=device, seed=seed + 1)
    g = torch.Generator().manual_seed(seed + 2)
    batch = {
        "src": torch.randint(4, v, (batch_size, L), generator=g),
        "src_len": torch.full((batch_size,), L),
        "tgt_in": torch.randint(4, v, (batch_size, L), generator=g),
        "tgt_out": torch.randint(4, v, (batch_size, L), generator=g),
        "tgt_mask": torch.ones(batch_size, L),
    }
    return student, nmt_task(student, teacher, device=device), batch


def train_parity(checks, args, quant, distill, cfg) -> dict:
    """One full-width step at B = 8 on the card and on the CPU (plain
    versions) from the same weights, with the body of ``make_train_step``
    written out so its gradients can be compared: loss, metrics, grad_norm
    and every gradient card against CPU; then the card's updated weights
    against the CPU optimizer applied to the card's gradients. (Adam's first
    step is lr * g / (|g| + eps), which turns gradient differences at the
    level of rounding into whole steps where |g| is near 0, so the two
    devices' own updated weights are compared and reported, not held.)"""
    runs = {}
    for dev in ("cuda", "cpu"):
        student, task, batch = kd_setup(args, dev, args.parity_batch, args.seed + 20)
        tx = build_optimizer(cfg)
        state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                   device=dev)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        loss, metrics, grads = loss_and_grads(
            task, state.params, as_batch(batch, torch.device(dev)), quant=quant, distill=distill)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads))
        runs[dev] = (metrics, grads, before, state, tx)
    (gm, gg, _, gstate, _), (cm, cg, cbefore, cstate, ctx) = runs["cuda"], runs["cpu"]
    out = {"batch": args.parity_batch}
    for k, v in cm.items():
        err = abs(float(gm[k]) - float(v))
        out[f"{k}_abs_diff"] = err
        checks.require(err <= LOSS_RTOL * abs(float(v)),
                       f"train parity {k}: card {float(gm[k])} vs cpu {float(v)}")
    g_card = {n: g.detach().cpu() for n, g in gg.items()}
    updates, _ = ctx.update(g_card, ctx.init(cbefore), cbefore)  # the CPU optimizer's step
    grad_rel = opt_err = own_err = 0.0
    own_over = 0
    for n, g_c in cg.items():
        scale = max(float(g_c.abs().max()), 1e-30)
        e = float((g_card[n] - g_c).abs().max())
        grad_rel = max(grad_rel, e / scale)
        checks.require(e <= GRAD_TOL * scale, f"train parity grad {n}: max abs diff {e}")
        w_card = gstate.params[n].detach().cpu()
        tol = W_ATOL + W_RTOL * cbefore[n].abs()
        d_opt = (w_card - (cbefore[n] + updates[n])).abs()
        opt_err = max(opt_err, float(d_opt.max()))
        checks.require(bool((d_opt <= tol).all()), f"train parity optimizer step {n}")
        d_own = (w_card - cstate.params[n].detach()).abs()
        own_err = max(own_err, float(d_own.max()))
        own_over += int((d_own > tol).sum())
    out.update(
        grad_max_rel_diff=grad_rel, optimizer_step_max_abs_diff=opt_err,
        weights_max_abs_diff=own_err, weights_over_tolerance=own_over,
        weights=sum(t.numel() for t in cbefore.values()),
    )
    return out


def step_breakdown(task, state, batch, quant, distill, tx, reps) -> dict:
    """Median host seconds of each stage of a 4-bit train step, with a
    synchronize after each (the body of ``make_train_step``, opened up)."""
    times = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    params = state.params
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        qp = stage("fake_quant_tree", lambda: quantized_params(params, quant))
        logits, _ = stage("student_forward", lambda: task.student_forward(qp, batch, True, None))
        t_logits = stage("teacher_forward", lambda: task.teacher_forward(batch))
        loss, _ = stage("loss", lambda: task.loss_and_metrics(logits, t_logits, batch, distill))
        grads = stage("backward", lambda: torch.autograd.grad(loss, list(params.values())))
        grads = dict(zip(params, grads))
        stage("optimizer", lambda: apply_updates(params, tx.update(grads, state.opt_state,
                                                                   params)[0]))
    return {k: statistics.median(v[1:]) for k, v in times.items()}  # the first warms up


def phase_train(checks, args, smi) -> dict:
    """The full-width 4-bit STE KD train path (see the module docstring)."""
    dev = torch.device("cuda")
    quant, distill = QuantSpec(bits=args.bits), DistillSpec()
    cfg = TrainConfig(learning_rate=1e-3, clip_norm=5.0)
    student, task, batch = kd_setup(args, dev, args.train_batch, args.seed + 10)
    row = phase_train_kernel(checks, student, torch.Generator().manual_seed(args.seed + 3))

    tx = build_optimizer(cfg)
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant, device=dev)
    step = make_train_step(task, tx, quant=quant, distill=distill, device=dev)
    eval_step = make_eval_step(task, quant=quant, device=dev)
    zero_counts()
    metrics = []
    for _ in range(args.train_steps):
        state, m = step(state, batch, args.seed)
        metrics.append(m)
    ev = eval_step(state, batch)
    launches = read_counts()
    loss = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    want = {"dequant_matmul": 0, "dequant_matmul_topk": 0, "beam_combine_topk": 0,
            "fake_quant_buckets": args.train_steps + 1}
    checks.require(launches == want, f"train path launches {launches}, expected {want}")
    checks.require(all(map(math.isfinite, loss + gnorm)), "train loss or grad_norm not finite")
    checks.require(loss[-1] < loss[0], f"train loss did not fall: {loss[0]} -> {loss[-1]}")
    parity = train_parity(checks, args, quant, distill, cfg)

    ntok = args.train_batch * args.src_len
    fp_step = make_train_step(task, tx, quant=None, distill=distill, device=dev)
    holder = {"state": state}

    def run(fn):
        holder["state"], m = fn(holder["state"], batch, args.seed)
        float(m["loss"])

    t_q, t_fp = [], []
    for i in range(args.reps):  # in turns, so drift on the host hits both alike
        for fn, out in ((step, t_q), (fp_step, t_fp))[:: 1 if i % 2 == 0 else -1]:
            out += timed_runs(lambda: run(fn), 1)
    med_q, med_fp = statistics.median(t_q), statistics.median(t_fp)
    stages = step_breakdown(task, holder["state"], as_batch(batch, dev), quant, distill, tx,
                            args.reps)
    torch.cuda.reset_peak_memory_stats()
    run(step)
    peak = torch.cuda.max_memory_allocated()
    emit({
        "phase": "train", "preset": args.preset, "teacher": "teacher", "vocab": args.vocab,
        "batch": args.train_batch, "len": args.src_len, "bits": args.bits, "steps": len(loss),
        "launches": launches, "loss": loss, "grad_norm": gnorm,
        "eval_nll_per_token": float(ev["nll_sum"]) / float(ev["n_tokens"]),
        "parity_cuda_vs_cpu": parity,
        "step_seconds_4bit": t_q, "step_seconds_fp32": t_fp,
        "tokens_per_s_4bit": ntok / med_q, "tokens_per_s_fp32": ntok / med_fp,
        "vs_baseline": med_fp / med_q, "peak_device_bytes": peak,
        "stage_seconds_4bit": stages, "card": smi,
    })
    phase_profile(lambda: run(step), med_q, phase="train_profile", focus="fake_quant_kernel")
    row["launches"] = launches["fake_quant_buckets"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="student_medium")
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--src-len", type=int, default=24)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--cpu-sentences", type=int, default=16)
    ap.add_argument("--train-batch", type=int, default=128)
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--parity-batch", type=int, default=8)
    args = ap.parse_args(argv)

    dev, smi = phase_device()
    # f32 matmuls (the FP32 beam_search leg, the f32 parity runs) in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    checks = Checks()
    model = make_seq2seq(args.preset, args.vocab, args.vocab, device="cuda", seed=args.seed)
    params = params_to_numpy(model)
    rows = args.batch * args.beam
    dec = pack_decoder(params, model.cfg, args.bits, compute_dtype=torch.bfloat16,
                       generator_group=pick_generator_group(rows), device="cuda")
    table = phase_kernels(checks, dec, rows, torch.Generator().manual_seed(args.seed + 2))
    launches = phase_main_path(checks, args, model, params, smi)
    for row in table:
        row["launches"] = launches[row["name"]]
    del model, dec
    table.append(phase_train(checks, args, smi))
    if checks.failed:
        print(f"{len(checks.failed)} check(s) failed", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
