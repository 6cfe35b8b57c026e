"""CIFAR-100 WideResNet: quantized distillation + differentiable
quantization (BASELINE config 2), the PyTorch port of the JAX package's
``examples/cifar100_wrn_diffquant.py``: the same flags, plus ``--device``;
the same flow, ``metrics.jsonl`` events and registry entries.

Train (or resume) a WRN teacher (cosine schedule), distill a smaller
student at 2/4-bit with uniform fake-quant (STE), then *differentiable
quantization*: freeze the student's weights and learn each layer's
quantization points by gradient descent (mode ``codebooks``), with optional
automatic bit-width assignment (``--auto-bits``) and Huffman-accounted
size. Under ``--workdir``: the run registry and checkpoints and
``metrics.jsonl``.

    python -m quantized_distillation_tpu_torch.examples.cifar100_wrn_diffquant --bits 2 \\
        --student student_small
    python -m quantized_distillation_tpu_torch.examples.cifar100_wrn_diffquant --device cpu \\
        --teacher student_small --synthetic-size 128 --teacher-epochs 1 --epochs 1 \\
        --diffquant-epochs 1 --auto-bits 3
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bits", type=int, default=2)
    p.add_argument("--student", default="student_small")
    p.add_argument("--teacher", default="student_medium",
                   help="WRN preset (use 'teacher' for WRN-28-10)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--teacher-epochs", type=int, default=8)
    p.add_argument("--diffquant-epochs", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--points-lr", type=float, default=1e-3)
    p.add_argument("--kd-weight", type=float, default=0.7)
    p.add_argument("--kd-temperature", type=float, default=5.0)
    p.add_argument("--codebook-init", default="quantile",
                   choices=["uniform", "quantile"])
    p.add_argument("--auto-bits", type=float, default=None,
                   help="target mean bits for automatic per-layer assignment")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic-size", type=int, default=None)
    p.add_argument("--workdir", default="runs/cifar100_wrn")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from quantized_distillation_tpu_torch._device import resolve_device
    from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
    from quantized_distillation_tpu_torch.data import batches, load_cifar
    from quantized_distillation_tpu_torch.data.cifar import BASE_DATA_FOLDER
    from quantized_distillation_tpu_torch.models import make_wrn
    from quantized_distillation_tpu_torch.ops.sizes import model_size_report
    from quantized_distillation_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        make_eval_step,
        vision_task,
    )
    from quantized_distillation_tpu_torch.train import quantize_tree as qt
    from quantized_distillation_tpu_torch.train.bits import assign_bits, gradient_sensitivities
    from quantized_distillation_tpu_torch.train.loops import evaluate, fit
    from quantized_distillation_tpu_torch.train.losses import cross_entropy
    from quantized_distillation_tpu_torch.train.manager import ExperimentManager
    from quantized_distillation_tpu_torch.train.trainer import as_batch
    from quantized_distillation_tpu_torch.utils.metrics import MetricsLogger

    dev = resolve_device(args.device)
    # the registry holds the JAX driver's config (every flag but the device)
    config = {k: v for k, v in vars(args).items() if k != "device"}
    data_dir = args.data_dir or BASE_DATA_FOLDER
    train_ds = load_cifar(100, True, data_dir, args.synthetic_size, args.seed)
    test_ds = load_cifar(100, False, data_dir, args.synthetic_size, args.seed)
    logger = MetricsLogger(os.path.join(args.workdir, "metrics.jsonl"))
    logger.log("data", source=train_ds.source, n_train=len(train_ds.labels))
    mgr = ExperimentManager(args.workdir)

    def train_stream(epoch):
        return batches(
            train_ds, args.batch_size, train_augment=True, seed=args.seed + epoch
        )

    def eval_stream():
        return batches(test_ds, args.batch_size, shuffle=False, drop_remainder=False)

    # ---- teacher WRN (FP32) ----
    teacher = make_wrn(args.teacher, num_classes=100, device=dev, seed=args.seed)
    tname = f"wrn_{args.teacher}_fp32"
    ttask = vision_task(teacher, device=dev)
    tcfg = TrainConfig(
        epochs=args.teacher_epochs, learning_rate=args.lr,
        batch_size=args.batch_size, seed=args.seed, lr_schedule="cosine",
    )
    ttx = build_optimizer(tcfg, steps_per_epoch=max(len(train_ds.labels) // args.batch_size, 1))
    tstate = create_train_state(dict(teacher.named_parameters()), ttx,
                                batch_stats=dict(teacher.named_buffers()), device=dev)
    if mgr.resume_or_register(tname, config):
        tstate = mgr.restore(tname, tstate)  # into the teacher's own tensors
    else:
        tstate = fit(
            ttask, tstate, tcfg, train_stream, eval_batches=eval_stream,
            tx=ttx, logger=logger, manager=mgr, model_name=tname, device=dev,
        )
    tacc = evaluate(make_eval_step(ttask, device=dev), tstate, eval_stream())["accuracy"]
    logger.log("teacher_eval", accuracy=tacc)

    # ---- student: KD with uniform fake-quant (warm start) ----
    student = make_wrn(args.student, num_classes=100, device=dev, seed=args.seed + 1)
    quant = QuantSpec(bits=args.bits)
    sname = f"wrn_{args.student}_{args.bits}bit"
    stask = vision_task(student, teacher, device=dev)
    scfg = TrainConfig(
        epochs=args.epochs, learning_rate=args.lr, batch_size=args.batch_size,
        seed=args.seed, quant=quant,
        distill=DistillSpec(weight=args.kd_weight, temperature=args.kd_temperature),
    )
    stx = build_optimizer(scfg)
    sstate = create_train_state(dict(student.named_parameters()), stx,
                                batch_stats=dict(student.named_buffers()), quant=quant,
                                device=dev)
    if not mgr.has_model(sname):
        mgr.add_new_model(sname, config)
    sstate = fit(
        stask, sstate, scfg, train_stream, eval_batches=eval_stream,
        tx=stx, logger=logger, manager=mgr, model_name=sname, device=dev,
    )
    uacc = evaluate(make_eval_step(stask, quant=quant, device=dev), sstate, eval_stream())[
        "accuracy"
    ]
    logger.log("student_uniform_eval", accuracy=uacc)

    # ---- optional automatic bit assignment ----
    bits_map = None
    if args.auto_bits:
        def loss_for_bits(params, batch):
            variables = {**params, **sstate.batch_stats}
            logits, _ = student.forward_with(variables, batch["image"].permute(0, 3, 1, 2),
                                             train=False)
            return cross_entropy(logits, batch["label"])

        sens_batches = [as_batch(b, dev) for _, b in zip(range(3), train_stream(0))]
        sens = gradient_sensitivities(loss_for_bits, sstate.params, sens_batches, quant)
        bits_map = assign_bits(qt.param_sizes(sstate.params), sens, args.auto_bits)
        logger.log("auto_bits", mean_target=args.auto_bits,
                   assigned=str(sorted(set(bits_map.values()))))

    # ---- differentiable quantization: learn codebooks, weights frozen ----
    # (over the student's own tensors: from here on they take no gradient)
    dq_quant = QuantSpec(bits=args.bits, method="codebook")
    dq_cfg = TrainConfig(
        epochs=args.diffquant_epochs, learning_rate=args.points_lr,
        batch_size=args.batch_size, seed=args.seed, quant=dq_quant,
        distill=DistillSpec(weight=args.kd_weight, temperature=args.kd_temperature),
    )
    dq_tx = build_optimizer(dq_cfg)
    dq_state = create_train_state(
        sstate.params, dq_tx, batch_stats=sstate.batch_stats, quant=dq_quant,
        codebook_init=args.codebook_init, mode="codebooks", device=dev,
    )
    dq_state = fit(
        stask, dq_state, dq_cfg, train_stream, eval_batches=eval_stream,
        tx=dq_tx, mode="codebooks", logger=logger, device=dev,
    )
    dacc = evaluate(make_eval_step(stask, quant=dq_quant, device=dev), dq_state,
                    eval_stream())["accuracy"]

    # ---- Huffman-accounted size ----
    streams = qt.index_streams(dq_state.params, dq_quant, dq_state.codebooks)
    sizes = qt.param_sizes(dq_state.params)
    rep = model_size_report(
        sizes,
        bits_map or args.bits,
        scaling=dq_quant.scaling,
        index_streams=streams,
        exclude=[k for k in sizes if k not in streams],
    )
    logger.log(
        "final",
        teacher_accuracy=tacc,
        student_uniform_accuracy=uacc,
        student_diffquant_accuracy=dacc,
        size_mb=rep.total_mb,
        compression_ratio=rep.compression_ratio,
        data_source=train_ds.source,
    )
    mgr.record_run(
        sname, "differentiable_quantization", config,
        {"uniform_acc": uacc, "diffquant_acc": dacc,
         "compression_ratio": rep.compression_ratio},
    )
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
