"""Seq2seq quantized distillation with beam-search BLEU (PyTorch port of
the JAX package's ``examples/wmt_distill.py``: the same flags, plus
``--device``; the same flow and ``metrics.jsonl`` events).

Train (or resume) an FP32 NMT teacher, distill a smaller student with
fake-quantized weights (``--method uniform``: mode ``weights``;
``codebook``: learned codebooks, mode ``joint``), evaluate the
hard-quantized student's perplexity and beam-search BLEU, report its
compressed size (measured Huffman code lengths of its levels), and write it
as a Huffman-coded ``.qdt`` artifact. Under ``--workdir``: the run
registry and checkpoints (``registry.json``, ``<model>/checkpoints/``),
``metrics.jsonl`` and ``<student>.qdt``.

Data: real parallel corpora via ``--src-train/--tgt-train/...``, either
pre-tokenized (one sentence per line, whitespace tokens) or raw text with
``--raw-text`` (Moses-style tokenization, optional ``--bpe-merges`` BPE,
detokenized BLEU; the pipelines and vocabularies are saved into
``--workdir`` for serving); else the deterministic toy reversal corpus.

    python -m quantized_distillation_tpu_torch.examples.wmt_distill --bits 4 --epochs 10
    python -m quantized_distillation_tpu_torch.examples.wmt_distill --device cpu \\
        --teacher-preset student_small --epochs 1 --teacher-epochs 1 --toy-size 200
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def bleu_eval(model, params, corpus, beam_cfg, batch_size=64, tgt_pipe=None, device="cuda"):
    """BLEU of the dense beam search of ``model`` (with ``params``, its
    parameter names → tensors, in place of its own weights when given) on
    ``corpus``: tokenized BLEU, or with ``tgt_pipe`` (raw-text mode) the
    detokenized mteval-13a BLEU of the detokenized hypotheses and
    references."""
    from quantized_distillation_tpu_torch.convert import params_to_numpy
    from quantized_distillation_tpu_torch.data import nmt_batches
    from quantized_distillation_tpu_torch.models import Seq2Seq
    from quantized_distillation_tpu_torch.serve import beam_search, tokens_to_sentences
    from quantized_distillation_tpu_torch.utils.bleu import corpus_bleu, detok_bleu

    if params is not None:
        model = Seq2Seq(model.cfg, device=device).load_params(params_to_numpy(params))
    hyps = {}
    for batch in nmt_batches(corpus, batch_size, shuffle=False):
        toks, _ = beam_search(model, torch.as_tensor(batch["src"]).long(),
                              torch.as_tensor(batch["src_len"]).long(), beam_cfg, device=device)
        for i, sent in zip(batch["index"], tokens_to_sentences(toks, corpus.tgt_vocab)):
            hyps[int(i)] = sent
    refs = [corpus.tgt_vocab.decode(t) for t in corpus.tgt]
    ordered = [hyps[i] for i in range(len(refs))]
    if tgt_pipe is not None:
        return detok_bleu([tgt_pipe.decode_tokens(h) for h in ordered],
                          [tgt_pipe.decode_tokens(r) for r in refs])
    return corpus_bleu(ordered, refs)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--method", default="uniform", choices=["uniform", "codebook"])
    p.add_argument("--teacher-preset", default="teacher")
    p.add_argument("--student-preset", default="student_small")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--teacher-epochs", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--clip-norm", type=float, default=5.0)
    p.add_argument("--kd-weight", type=float, default=0.5)
    p.add_argument("--kd-temperature", type=float, default=2.0)
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--max-decode-len", type=int, default=32)
    # GNMT length and coverage penalties, off by default
    p.add_argument("--length-penalty", type=float, default=0.0)
    p.add_argument("--coverage-penalty", type=float, default=0.0)
    # real data: preprocessed WMT13 de-en files
    p.add_argument("--src-train"), p.add_argument("--tgt-train")
    p.add_argument("--src-test"), p.add_argument("--tgt-test")
    # raw-text mode: Moses-style tokenize (+ optional BPE) + detok BLEU
    p.add_argument("--raw-text", action="store_true",
                   help="train files are RAW text: tokenize/BPE/detok here")
    p.add_argument("--bpe-merges", type=int, default=0,
                   help="BPE merge ops per side (0 = word-level, the paper setting)")
    p.add_argument("--src-lang", default="de"), p.add_argument("--tgt-lang", default="en")
    # the toy corpus, when no files are given
    p.add_argument("--toy-size", type=int, default=4000)
    p.add_argument("--toy-vocab", type=int, default=120)
    p.add_argument("--workdir", default="runs/wmt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from quantized_distillation_tpu_torch._device import resolve_device
    from quantized_distillation_tpu_torch.config import (
        BeamConfig, DistillSpec, QuantSpec, TrainConfig,
    )
    from quantized_distillation_tpu_torch.data import (
        load_parallel_files, load_raw_parallel, nmt_batches, toy_corpus,
    )
    from quantized_distillation_tpu_torch.models import make_seq2seq
    from quantized_distillation_tpu_torch.ops.sizes import model_size_report
    from quantized_distillation_tpu_torch.train import (
        build_optimizer, create_train_state, make_eval_step, nmt_task,
    )
    from quantized_distillation_tpu_torch.train import quantize_tree as qt
    from quantized_distillation_tpu_torch.train.loops import evaluate, fit
    from quantized_distillation_tpu_torch.train.manager import ExperimentManager
    from quantized_distillation_tpu_torch.utils.artifact import save_artifact
    from quantized_distillation_tpu_torch.utils.metrics import MetricsLogger

    dev = resolve_device(args.device)
    logger = MetricsLogger(os.path.join(args.workdir, "metrics.jsonl"))
    mgr = ExperimentManager(args.workdir)

    tgt_pipe = None
    if args.src_train and args.tgt_train and args.raw_text:
        train_c, src_pipe, tgt_pipe = load_raw_parallel(
            args.src_train, args.tgt_train,
            src_lang=args.src_lang, tgt_lang=args.tgt_lang,
            bpe_merges=args.bpe_merges or None,
        )
        test_c, _, _ = load_raw_parallel(
            args.src_test, args.tgt_test,
            src_pipe=src_pipe, tgt_pipe=tgt_pipe,
            src_vocab=train_c.src_vocab, tgt_vocab=train_c.tgt_vocab,
        )
        # the preprocessing, saved for serving (the same pipeline)
        os.makedirs(args.workdir, exist_ok=True)
        src_pipe.save(args.workdir, "src")
        tgt_pipe.save(args.workdir, "tgt")
        train_c.src_vocab.save(os.path.join(args.workdir, "src.vocab"))
        train_c.tgt_vocab.save(os.path.join(args.workdir, "tgt.vocab"))
    elif args.src_train and args.tgt_train:
        train_c = load_parallel_files(args.src_train, args.tgt_train)
        test_c = load_parallel_files(
            args.src_test, args.tgt_test,
            src_vocab=train_c.src_vocab, tgt_vocab=train_c.tgt_vocab,
        )
    else:
        train_c = toy_corpus(n=args.toy_size, vocab_size=args.toy_vocab, seed=args.seed)
        test_c = toy_corpus(n=max(args.toy_size // 20, 50), vocab_size=args.toy_vocab,
                            seed=args.seed + 991)
    logger.log("data", source=train_c.source, n_train=len(train_c.src),
               src_vocab=len(train_c.src_vocab), tgt_vocab=len(train_c.tgt_vocab))

    sv_n, tv_n = len(train_c.src_vocab), len(train_c.tgt_vocab)
    beam_cfg = BeamConfig(
        beam_size=args.beam, max_len=args.max_decode_len,
        length_penalty=args.length_penalty, coverage_penalty=args.coverage_penalty,
    )

    def train_stream(epoch):
        return nmt_batches(train_c, args.batch_size, seed=args.seed + epoch,
                           drop_remainder=True)

    def eval_stream():
        return nmt_batches(test_c, args.batch_size, shuffle=False)

    def token_count(batch):
        return int(np.asarray(batch["tgt_mask"]).sum())

    # ---- teacher (FP32) ----
    teacher = make_seq2seq(args.teacher_preset, sv_n, tv_n, device=dev, seed=args.seed)
    tname = f"nmt_{args.teacher_preset}_fp32"
    ttask = nmt_task(teacher, device=dev)
    tcfg = TrainConfig(epochs=args.teacher_epochs, learning_rate=args.lr,
                       clip_norm=args.clip_norm, seed=args.seed)
    ttx = build_optimizer(tcfg)
    tstate = create_train_state(dict(teacher.named_parameters()), ttx, device=dev)
    # Resume the teacher only when the registered run config matches this
    # invocation's; only the flags that shape the trained teacher's weights
    # take part (decode and eval flags, student flags and the device do not).
    teacher_keys = (
        "teacher_preset", "teacher_epochs", "batch_size", "lr", "clip_norm",
        "seed", "src_train", "tgt_train", "raw_text", "bpe_merges",
        "src_lang", "tgt_lang", "toy_size", "toy_vocab",
    )
    tconfig = {k: getattr(args, k) for k in teacher_keys}
    if mgr.resume_or_register(tname, tconfig):
        tstate = mgr.restore(tname, tstate)  # into the teacher's own parameters
        logger.log("teacher_resume", step=float(mgr.latest_step(tname)))
    else:
        tstate = fit(ttask, tstate, tcfg, train_stream, eval_batches=eval_stream,
                     tx=ttx, logger=logger, manager=mgr, model_name=tname,
                     item_count=token_count, device=dev)
    t_bleu = bleu_eval(teacher, None, test_c, beam_cfg, args.batch_size,
                       tgt_pipe=tgt_pipe, device=dev)
    logger.log("teacher_eval", bleu=t_bleu)

    # ---- student: quantized word-level distillation ----
    student = make_seq2seq(args.student_preset, sv_n, tv_n, device=dev, seed=args.seed + 1)
    quant = QuantSpec(bits=args.bits, method=args.method)
    sname = f"nmt_{args.student_preset}_{args.bits}bit_{args.method}"
    stask = nmt_task(student, teacher, device=dev)
    scfg = TrainConfig(
        epochs=args.epochs, learning_rate=args.lr, clip_norm=args.clip_norm,
        seed=args.seed, quant=quant,
        distill=DistillSpec(weight=args.kd_weight, temperature=args.kd_temperature),
    )
    stx = build_optimizer(scfg)
    mode = "joint" if args.method == "codebook" else "weights"
    sstate = create_train_state(dict(student.named_parameters()), stx, quant=quant,
                                codebook_init="uniform", mode=mode, device=dev)
    if not mgr.has_model(sname):
        mgr.add_new_model(sname, vars(args))
    sstate = fit(stask, sstate, scfg, train_stream, eval_batches=eval_stream,
                 tx=stx, mode=mode, logger=logger, manager=mgr, model_name=sname,
                 item_count=token_count, device=dev)

    # quantized-deploy eval: hard-quantize the weights, then perplexity + BLEU
    q_params = qt.quantize_tree_hard(sstate.params, quant, sstate.codebooks)
    ppl = evaluate(make_eval_step(stask, quant=quant, device=dev), sstate, eval_stream())
    s_bleu = bleu_eval(student, q_params, test_c, beam_cfg, args.batch_size,
                       tgt_pipe=tgt_pipe, device=dev)

    streams = qt.index_streams(sstate.params, quant, sstate.codebooks)
    sizes = qt.param_sizes(sstate.params)
    rep = model_size_report(
        sizes, args.bits, scaling=quant.scaling, index_streams=streams,
        exclude=[k for k in sizes if k not in streams],
    )
    artifact = save_artifact(os.path.join(args.workdir, f"{sname}.qdt"), sstate.params, quant,
                             codebooks=sstate.codebooks, meta={"model": sname,
                                                               "step": sstate.step})
    logger.log(
        "final",
        teacher_bleu=t_bleu,
        student_quantized_bleu=s_bleu,
        student_perplexity=ppl.get("perplexity", float("nan")),
        size_mb=rep.total_mb,
        compression_ratio=rep.compression_ratio,
        artifact_bytes=artifact["file_bytes"],
        data_source=train_c.source,
    )
    mgr.record_run(sname, "nmt_quantized_distillation", vars(args),
                   {"bleu": s_bleu, "teacher_bleu": t_bleu,
                    "compression_ratio": rep.compression_ratio})
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
