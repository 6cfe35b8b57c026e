"""The paper's qualitative accuracy contract on synthetic data (the PyTorch
port's counterpart of the JAX package's ``scripts/accuracy_grid.py``).

The paper's contract (arXiv:1802.05668):

1. 4-bit quantized distillation ~= the FP-distilled student (CIFAR + NMT),
2. 2-bit degrades the SMALLEST students badly,
3. widening the student recovers the 2-bit loss.

This driver distills a bits x student-width grid of students on the
synthetic and toy tasks and checks those orderings (``contract_checks``):

- CNN on labeled synthetic CIFAR-100 (100 classes, few samples per class):
  students {narrow, wide} x bits {2, 4, 8, fp32};
- WRN-28-10 → WRN-16-2 / WRN-16-4 on the same task with ``--wrn``: bits
  {2, 4, fp32};
- LSTM seq2seq on the toy reversal corpus: students {narrow, wide} x bits
  {2, 4, fp32}, deployed hard-quantized and scored by beam-search BLEU.

Each quantized student trains with the fake-quant kernel (one launch a
step, one a quantized eval batch or deploy). Weights come from the port's
seeded init at the JAX script's ``PRNGKey`` integers: teachers and the NMT
models at ``--seed``, the vision students at ``--seed + 1``.

    python -m quantized_distillation_tpu_torch.scripts.accuracy_grid --wrn
    python -m quantized_distillation_tpu_torch.scripts.accuracy_grid --device cpu \\
        --cnn-teacher student_small --cnn-data 256 --epochs 1 --teacher-epochs 1 \\
        --nmt-data 300 --nmt-epochs 1 --batch 32

Prints the JAX script's lines, one wall-seconds line a grid and, as the
last line, one JSON object with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .._device import resolve_device
from ..config import BeamConfig, DistillSpec, QuantSpec, TrainConfig
from ..data import batches, load_cifar, nmt_batches, toy_corpus
from ..kernels import launch_counts, launches_since
from ..models import make_cnn, make_seq2seq, make_wrn
from ..serve import beam_search, tokens_to_sentences
from ..train import (
    build_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
    nmt_task,
    vision_task,
)
from ..train import quantize_tree as qt
from ..train.loops import evaluate, fit
from ..utils.bleu import corpus_bleu

# synthetic CIFAR: no directory holds the real archives
NO_DATA_DIR = "/nonexistent"


def vision_cell(make_fn, teacher_pack, student_preset, bits, args, label):
    """Distill one vision student at the given bit width → hard-quant acc."""
    teacher, train_ds, test_ds = teacher_pack
    dev = resolve_device(args.device)
    quant = QuantSpec(bits=bits) if bits else None
    # quantized students need the longer decaying schedule (the paper
    # trains quantized students well past the FP schedule)
    scfg = TrainConfig(
        epochs=args.epochs, learning_rate=args.lr, batch_size=args.batch,
        seed=args.seed, quant=quant, lr_schedule="cosine",
        distill=DistillSpec(weight=0.7, temperature=5.0),
    )
    student = make_fn(student_preset, num_classes=train_ds.num_classes, device=dev,
                      seed=args.seed + 1)
    task = vision_task(student, teacher, device=dev)
    steps_per_epoch = max(len(train_ds.labels) // args.batch, 1)
    tx = build_optimizer(scfg, steps_per_epoch)
    state = create_train_state(dict(student.named_parameters()), tx,
                               batch_stats=dict(student.named_buffers()), quant=quant,
                               device=dev)
    state = fit(
        task, state, scfg,
        lambda epoch: batches(train_ds, args.batch, train_augment=True, seed=args.seed + epoch),
        tx=tx, device=dev,
    )
    ev = make_eval_step(task, quant=quant, device=dev)
    return evaluate(
        ev, state, batches(test_ds, args.batch, shuffle=False, drop_remainder=False)
    )["accuracy"]


def run_vision_grid(args, make_fn, teacher_preset, student_presets, label,
                    bit_list=(None, 8, 4, 2), n_data=None):
    """Bits × student-width grid for one vision family (CNN or WRN): train
    the FP teacher, then distill every (preset, bits) student from it."""
    dev = resolve_device(args.device)
    n_data = n_data or args.cnn_data
    train_ds = load_cifar(100, True, NO_DATA_DIR, n_data, args.seed)
    test_ds = load_cifar(100, False, NO_DATA_DIR, n_data // 4, args.seed)
    teacher = make_fn(teacher_preset, num_classes=100, device=dev, seed=args.seed)
    tcfg = TrainConfig(epochs=args.teacher_epochs, learning_rate=args.lr,
                       batch_size=args.batch, seed=args.seed)
    ttask = vision_task(teacher, device=dev)
    ttx = build_optimizer(tcfg)
    tstate = fit(
        ttask,
        create_train_state(dict(teacher.named_parameters()), ttx,
                           batch_stats=dict(teacher.named_buffers()), device=dev),
        tcfg,
        lambda epoch: batches(train_ds, args.batch, train_augment=True, seed=args.seed + epoch),
        tx=ttx, device=dev,
    )
    tacc = evaluate(
        make_eval_step(ttask, device=dev), tstate,
        batches(test_ds, args.batch, shuffle=False, drop_remainder=False),
    )["accuracy"]
    print(f"[{label}] teacher ({teacher_preset} preset) acc {tacc:.3f}", flush=True)

    # the teacher's model holds its trained weights and statistics
    pack = (teacher, train_ds, test_ds)
    grid = {}
    for preset in student_presets:
        for bits in bit_list:
            acc = vision_cell(make_fn, pack, preset, bits, args, label)
            grid[f"{preset}@{bits or 'fp32'}"] = round(float(acc), 4)
            print(f"[{label}] {preset} bits={bits or 'fp32'}: acc {acc:.3f}", flush=True)
    return {"teacher_acc": round(float(tacc), 4), "cells": grid}


def run_cnn_grid(args):
    return run_vision_grid(
        args, make_cnn, args.cnn_teacher, ("student_small", "student_medium"), "cnn",
    )


def run_wrn_grid(args):
    return run_vision_grid(
        args, make_wrn, "teacher",  # WRN-28-10
        ("student_small", "student_medium"),  # 16-2 (narrow) vs 16-4 (wider)
        "wrn", bit_list=(None, 4, 2), n_data=args.wrn_data,
    )


def run_nmt_grid(args):
    dev = resolve_device(args.device)
    corpus = toy_corpus(n=args.nmt_data, vocab_size=200, min_len=5, max_len=9, seed=args.seed)
    test = toy_corpus(n=256, vocab_size=200, min_len=5, max_len=9, seed=args.seed + 999)

    def new_model(preset, **kw):
        return make_seq2seq(preset, len(corpus.src_vocab), len(corpus.tgt_vocab), dropout=0.0,
                            device=dev, seed=args.seed, **kw)

    def train_model(model, teacher=None, bits=None):
        """Train a copy of ``model``'s weights (KD from ``teacher`` when
        given) → its state; ``model`` keeps its own, as the JAX script's
        step does not donate."""
        quant = QuantSpec(bits=bits) if bits else None
        task = nmt_task(model, teacher, device=dev)
        tx = build_optimizer(TrainConfig(learning_rate=3e-3, clip_norm=5.0))
        state = create_train_state(dict(model.named_parameters()), tx, quant=quant, device=dev)
        step = make_train_step(
            task, tx, quant=quant,
            distill=DistillSpec(weight=0.7, temperature=5.0) if teacher else None,
            donate=False, device=dev,
        )
        for epoch in range(args.nmt_epochs):
            for batch in nmt_batches(corpus, args.batch, seed=epoch, drop_remainder=True):
                batch.pop("index")
                state, _ = step(state, batch, 1)
        return state

    def bleu_of(model, params, bits):
        # deploy path: HARD-quantized weights into the model, beam decode,
        # corpus BLEU
        if bits:
            params = qt.quantize_tree_hard(params, QuantSpec(bits=bits))
        with torch.no_grad():
            for name, t in model.named_parameters():
                t.copy_(params[name])
        tb = next(nmt_batches(test, 256, shuffle=False))
        toks, _ = beam_search(
            model, torch.as_tensor(tb["src"]).long(), torch.as_tensor(tb["src_len"]).long(),
            BeamConfig(beam_size=5, max_len=12), device=dev,
        )
        hyp = tokens_to_sentences(toks, test.tgt_vocab)
        refs = [test.tgt_vocab.decode(t) for t in test.tgt]
        order = [int(i) for i in tb["index"]]
        return corpus_bleu(hyp, [refs[i] for i in order])

    teacher = new_model("student_medium")
    tstate = train_model(teacher)
    tbleu = bleu_of(teacher, tstate.params, None)
    print(f"[nmt] teacher (256h) BLEU {tbleu:.1f}", flush=True)

    widths = {"narrow_64h": dict(hidden=64, embed_dim=64),
              "wide_128h": dict(hidden=128, embed_dim=128)}
    grid = {}
    for name, kw in widths.items():
        for bits in (None, 4, 2):
            student = new_model("student_small", **kw)
            sstate = train_model(student, teacher, bits)
            b = bleu_of(student, sstate.params, bits)
            grid[f"{name}@{bits or 'fp32'}"] = round(float(b), 2)
            print(f"[nmt] {name} bits={bits or 'fp32'}: BLEU {b:.1f}", flush=True)
    return {"teacher_bleu": round(float(tbleu), 2), "cells": grid}


def contract_checks(out: dict) -> dict:
    """The paper's qualitative orderings, asserted where both cells exist."""
    checks = {}
    cnn = out.get("cnn_synthetic_cifar100", {}).get("cells", {})
    if cnn:
        checks["cnn_4bit_within_2pts_of_fp"] = bool(
            cnn["student_small@4"] >= cnn["student_small@fp32"] - 0.02
        )
        checks["cnn_2bit_degrades_narrow"] = bool(
            cnn["student_small@2"] <= cnn["student_small@4"]
        )
        checks["cnn_widening_recovers_2bit"] = bool(
            cnn["student_medium@2"] >= cnn["student_small@2"]
        )
    wrn = out.get("wrn_synthetic_cifar100", {}).get("cells", {})
    if wrn:
        checks["wrn_4bit_within_2pts_of_fp"] = bool(
            wrn["student_small@4"] >= wrn["student_small@fp32"] - 0.02
        )
        checks["wrn_2bit_degrades_narrow"] = bool(
            wrn["student_small@2"] <= wrn["student_small@4"]
        )
        checks["wrn_widening_recovers_2bit"] = bool(
            wrn["student_medium@2"] >= wrn["student_small@2"]
        )
    nmt = out.get("nmt_toy", {}).get("cells", {})
    if nmt:
        checks["nmt_4bit_within_2bleu_of_fp"] = bool(
            nmt["narrow_64h@4"] >= nmt["narrow_64h@fp32"] - 2.0
        )
        checks["nmt_widening_recovers_2bit"] = bool(
            nmt["wide_128h@2"] >= nmt["narrow_64h@2"]
        )
    return checks


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12, help="CNN student epochs")
    ap.add_argument("--teacher-epochs", type=int, default=10)
    ap.add_argument("--nmt-epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cnn-data", type=int, default=4096)
    ap.add_argument("--wrn-data", type=int, default=2048)
    ap.add_argument("--nmt-data", type=int, default=6000)
    ap.add_argument("--cnn-teacher", default="teacher",
                    help="CNN teacher preset (the reference's full 'teacher' by default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-cnn", action="store_true")
    ap.add_argument("--skip-nmt", action="store_true")
    ap.add_argument("--wrn", action="store_true", help="run the WRN-28-10 grid")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None, report=None) -> int:
    """Run the grids the flags ask for and print the result. ``report`` (a
    dict), when given, receives each grid's wall seconds and kernel
    launches (0 on the CPU, where the plain versions run)."""
    args = parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        # true-f32 convolutions and matmuls, as the drivers train
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    grids = (("cnn_synthetic_cifar100", "cnn", run_cnn_grid, not args.skip_cnn),
             ("wrn_synthetic_cifar100", "wrn", run_wrn_grid, args.wrn),
             ("nmt_toy", "nmt", run_nmt_grid, not args.skip_nmt))
    out = {}
    for key, label, run, wanted in grids:
        if wanted:
            before, t0 = launch_counts(), time.perf_counter()
            out[key] = run(args)
            seconds = time.perf_counter() - t0
            print(f"[{label}] grid wall seconds {seconds:.3f}", flush=True)
            if report is not None:
                report[label] = {"seconds": seconds, "launches": launches_since(before)}
    out["contract_checks"] = contract_checks(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
