"""Penn-Treebank-style LSTM LM quantized distillation, the PyTorch port of
the JAX package's ``examples/ptb_lm_distill.py``: the same flags, plus
``--device``; the same flow, ``metrics.jsonl`` events and registry entries.

Train (or resume) an FP32 LSTM LM teacher (Zaremba-style), distill a
smaller student with fake-quantized weights (STE, 2/4/8-bit bucketed),
report the quantized student's perplexity and compressed size. The LSTM
carry runs on across the contiguous-BPTT windows (reset at each epoch and
each eval pass). Under ``--workdir``: the run registry and checkpoints and
``metrics.jsonl``.

Runs on a real tokenized corpus if ``--train-file``/``--valid-file`` are
given (PTB convention: whitespace tokens, one sentence per line), else on
the synthetic Markov-chain language (labelled ``data_source: synthetic``).

    python -m quantized_distillation_tpu_torch.examples.ptb_lm_distill --bits 4 \\
        --student student_small --teacher-epochs 4 --epochs 6
    python -m quantized_distillation_tpu_torch.examples.ptb_lm_distill --device cpu \\
        --teacher student_small --synthetic-tokens 4000 --synthetic-vocab 64 \\
        --batch-size 8 --bptt 10 --teacher-epochs 1 --epochs 1
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--student", default="student_small")
    p.add_argument("--teacher", default="teacher")
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--teacher-epochs", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--bptt", type=int, default=35)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--kd-weight", type=float, default=0.7)
    p.add_argument("--kd-temperature", type=float, default=5.0)
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--train-file", default=None)
    p.add_argument("--valid-file", default=None)
    p.add_argument("--synthetic-tokens", type=int, default=120_000)
    p.add_argument("--synthetic-vocab", type=int, default=256)
    p.add_argument("--workdir", default="runs/ptb_lm")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from quantized_distillation_tpu_torch._device import resolve_device
    from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
    from quantized_distillation_tpu_torch.data import (
        lm_batches,
        load_token_file,
        synthetic_lm_corpus,
    )
    from quantized_distillation_tpu_torch.models import make_lm
    from quantized_distillation_tpu_torch.ops.sizes import model_size_report
    from quantized_distillation_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        lm_initial_carry,
        lm_task,
        make_eval_step,
    )
    from quantized_distillation_tpu_torch.train import quantize_tree as qt
    from quantized_distillation_tpu_torch.train.loops import evaluate, fit
    from quantized_distillation_tpu_torch.train.manager import ExperimentManager
    from quantized_distillation_tpu_torch.utils.metrics import MetricsLogger

    dev = resolve_device(args.device)
    # the registry holds the JAX driver's config (every flag but the device)
    config = {k: v for k, v in vars(args).items() if k != "device"}
    if args.train_file:
        train_corpus = load_token_file(args.train_file)
        valid_corpus = load_token_file(
            args.valid_file or args.train_file, vocab=train_corpus.vocab
        )
    else:
        train_corpus = synthetic_lm_corpus(
            args.synthetic_tokens, args.synthetic_vocab, seed=args.seed
        )
        valid_corpus = synthetic_lm_corpus(
            max(args.synthetic_tokens // 10, 2000),
            args.synthetic_vocab,
            seed=args.seed + 1,
        )
    vocab = len(train_corpus.vocab)
    logger = MetricsLogger(os.path.join(args.workdir, "metrics.jsonl"))
    logger.log(
        "data",
        source=train_corpus.source,
        vocab=vocab,
        n_train_tokens=int(train_corpus.tokens.size),
    )
    mgr = ExperimentManager(args.workdir)

    def train_stream(epoch):
        return lm_batches(train_corpus, args.batch_size, args.bptt)

    def eval_stream():
        # the eval lanes have the training batch size: the carries below fit both
        return lm_batches(valid_corpus, args.batch_size, args.bptt)

    # ---- teacher: FP32 training (or reload) ----
    teacher = make_lm(args.teacher, vocab, device=dev, seed=args.seed)
    tname = f"lm_{args.teacher}_fp32"
    tcfg = TrainConfig(
        epochs=args.teacher_epochs, learning_rate=args.lr,
        batch_size=args.batch_size, seed=args.seed, clip_norm=5.0,
    )
    # thread_carry: standard PTB recipe — LSTM state continues across the
    # contiguous-BPTT windows (cut from the graph at boundaries), reset per epoch
    ttask = lm_task(teacher, thread_carry=True, device=dev)
    tcarry = lm_initial_carry(teacher, args.batch_size)
    ttx = build_optimizer(tcfg)
    tstate = create_train_state(dict(teacher.named_parameters()), ttx, carry=tcarry,
                                device=dev)
    if mgr.resume_or_register(tname, config):
        tstate = mgr.restore(tname, tstate)  # into the teacher's own tensors
        logger.log("teacher_restored", step=int(tstate.step))
    else:
        tstate = fit(
            ttask, tstate, tcfg, train_stream,
            eval_batches=eval_stream, tx=ttx, logger=logger,
            manager=mgr, model_name=tname, carry_reset=tcarry, device=dev,
        )
    tppl = evaluate(
        make_eval_step(ttask, device=dev), tstate, eval_stream(), initial_carry=tcarry
    )["perplexity"]
    logger.log("teacher_eval", perplexity=tppl)

    # ---- student: quantized distillation ----
    student = make_lm(args.student, vocab, device=dev, seed=args.seed + 1)
    sname = f"lm_{args.student}_{args.bits}bit"
    quant = QuantSpec(bits=args.bits, stochastic=args.stochastic)
    scfg = TrainConfig(
        epochs=args.epochs, learning_rate=args.lr, batch_size=args.batch_size,
        seed=args.seed, clip_norm=5.0, quant=quant,
        distill=DistillSpec(weight=args.kd_weight, temperature=args.kd_temperature),
    )
    stask = lm_task(student, teacher, thread_carry=True, device=dev)
    scarry = lm_initial_carry(student, args.batch_size, teacher)
    stx = build_optimizer(scfg)
    sstate = create_train_state(dict(student.named_parameters()), stx, quant=quant,
                                carry=scarry, device=dev)
    if not mgr.has_model(sname):
        mgr.add_new_model(sname, config)
    sstate = fit(
        stask, sstate, scfg, train_stream,
        eval_batches=eval_stream, tx=stx, logger=logger,
        manager=mgr, model_name=sname, carry_reset=scarry, device=dev,
    )

    # ---- report: quantized perplexity + compressed size ----
    sppl = evaluate(
        make_eval_step(stask, quant=quant, device=dev), sstate, eval_stream(),
        initial_carry=scarry,
    )["perplexity"]
    streams = qt.index_streams(sstate.params, quant)
    sizes = qt.param_sizes(sstate.params)
    rep = model_size_report(
        sizes, args.bits, scaling=quant.scaling, index_streams=streams,
        exclude=[k for k in sizes if k not in streams],
    )
    logger.log(
        "final",
        teacher_perplexity=tppl,
        student_quantized_perplexity=sppl,
        size_mb=rep.total_mb,
        compression_ratio=rep.compression_ratio,
        data_source=train_corpus.source,
    )
    mgr.record_run(
        sname, "quantized_distillation", config,
        {"perplexity": sppl, "teacher_perplexity": tppl,
         "compression_ratio": rep.compression_ratio},
    )
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
