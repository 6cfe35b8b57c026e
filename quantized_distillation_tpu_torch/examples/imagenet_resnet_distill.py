"""ImageNet-family ResNet quantized distillation, the PyTorch port of the JAX
package's ``examples/imagenet_resnet_distill.py``: the same flags, plus
``--device``; the same flow, ``metrics.jsonl`` events and registry entries.

Train (or resume) an FP32 ResNet teacher, distill a width-reduced student
with fake-quantized weights (STE, 2/4/8-bit bucketed), report the quantized
student's top-1 and compressed size. Under ``--workdir``: the run registry
and checkpoints and ``metrics.jsonl``.

Runs on downsampled-ImageNet npy packs if present under ``--data-dir``
(``{train,val}_images.npy`` + labels), else on the synthetic stand-in
(labelled ``data_source: synthetic``). Default resolution 64
(Imagenet64-style). The synthetic default is 20,000 training images (983 MB
of host memory at 64 px): pass ``--synthetic-size`` for a smaller run.

    python -m quantized_distillation_tpu_torch.examples.imagenet_resnet_distill --bits 4 \\
        --teacher resnet18 --student resnet18_half --num-classes 100
    python -m quantized_distillation_tpu_torch.examples.imagenet_resnet_distill --device cpu \\
        --teacher resnet18_quarter --student resnet18_quarter --image-size 32 \\
        --num-classes 10 --synthetic-size 128 --teacher-epochs 1 --epochs 1
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--student", default="resnet18_half")
    p.add_argument("--teacher", default="resnet18")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--teacher-epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--kd-weight", type=float, default=0.7)
    p.add_argument("--kd-temperature", type=float, default=5.0)
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--synthetic-size", type=int, default=None)
    p.add_argument("--workdir", default="runs/imagenet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from quantized_distillation_tpu_torch._device import resolve_device
    from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
    from quantized_distillation_tpu_torch.data import batches, load_imagenet
    from quantized_distillation_tpu_torch.data.cifar import BASE_DATA_FOLDER
    from quantized_distillation_tpu_torch.models import make_resnet
    from quantized_distillation_tpu_torch.ops.sizes import model_size_report
    from quantized_distillation_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        make_eval_step,
        vision_task,
    )
    from quantized_distillation_tpu_torch.train import quantize_tree as qt
    from quantized_distillation_tpu_torch.train.loops import evaluate, fit
    from quantized_distillation_tpu_torch.train.manager import ExperimentManager
    from quantized_distillation_tpu_torch.utils.metrics import MetricsLogger

    dev = resolve_device(args.device)
    # the registry holds the JAX driver's config (every flag but the device)
    config = {k: v for k, v in vars(args).items() if k != "device"}
    data_dir = args.data_dir or BASE_DATA_FOLDER
    kw = dict(
        data_dir=data_dir, image_size=args.image_size,
        num_classes=args.num_classes, synthetic_size=args.synthetic_size,
        seed=args.seed,
    )
    train_ds = load_imagenet(True, **kw)
    test_ds = load_imagenet(
        False, **{**kw, "synthetic_size": (args.synthetic_size or 2000) // 4 or None}
    )
    num_classes = train_ds.num_classes
    logger = MetricsLogger(os.path.join(args.workdir, "metrics.jsonl"))
    logger.log(
        "data", source=train_ds.source, n_train=len(train_ds.labels),
        image_size=args.image_size, num_classes=num_classes,
    )
    mgr = ExperimentManager(args.workdir)
    small = args.image_size <= 64

    def train_stream(ds, augment_):
        def gen(epoch):
            return batches(
                ds, args.batch_size, train_augment=augment_, seed=args.seed + epoch
            )
        return gen

    def eval_stream():
        return batches(test_ds, args.batch_size, shuffle=False, drop_remainder=False)

    # ---- teacher: FP32 training (or reload) ----
    teacher = make_resnet(args.teacher, num_classes, small_inputs=small, device=dev,
                          seed=args.seed)
    tname = f"imagenet_{args.teacher}_fp32"
    tcfg = TrainConfig(
        epochs=args.teacher_epochs, learning_rate=args.lr,
        batch_size=args.batch_size, seed=args.seed,
    )
    ttask = vision_task(teacher, device=dev)
    ttx = build_optimizer(tcfg)
    tstate = create_train_state(dict(teacher.named_parameters()), ttx,
                                batch_stats=dict(teacher.named_buffers()), device=dev)
    if mgr.resume_or_register(tname, config):
        tstate = mgr.restore(tname, tstate)  # into the teacher's own tensors
        logger.log("teacher_restored", step=int(tstate.step))
    else:
        tstate = fit(
            ttask, tstate, tcfg, train_stream(train_ds, True),
            eval_batches=eval_stream, tx=ttx, logger=logger,
            manager=mgr, model_name=tname, device=dev,
        )
    tacc = evaluate(make_eval_step(ttask, device=dev), tstate, eval_stream())["accuracy"]
    logger.log("teacher_eval", accuracy=tacc)

    # ---- student: quantized distillation ----
    student = make_resnet(args.student, num_classes, small_inputs=small, device=dev,
                          seed=args.seed + 1)
    sname = f"imagenet_{args.student}_{args.bits}bit"
    quant = QuantSpec(bits=args.bits, stochastic=args.stochastic)
    scfg = TrainConfig(
        epochs=args.epochs, learning_rate=args.lr, batch_size=args.batch_size,
        seed=args.seed, quant=quant,
        distill=DistillSpec(weight=args.kd_weight, temperature=args.kd_temperature),
    )
    stask = vision_task(student, teacher, device=dev)
    stx = build_optimizer(scfg)
    sstate = create_train_state(dict(student.named_parameters()), stx,
                                batch_stats=dict(student.named_buffers()), quant=quant,
                                device=dev)
    if not mgr.has_model(sname):
        mgr.add_new_model(sname, config)
    sstate = fit(
        stask, sstate, scfg, train_stream(train_ds, True),
        eval_batches=eval_stream, tx=stx, logger=logger,
        manager=mgr, model_name=sname, device=dev,
    )

    # ---- report: quantized accuracy + compressed size ----
    sacc = evaluate(make_eval_step(stask, quant=quant, device=dev), sstate, eval_stream())[
        "accuracy"
    ]
    streams = qt.index_streams(sstate.params, quant)
    sizes = qt.param_sizes(sstate.params)
    rep = model_size_report(
        sizes, args.bits, scaling=quant.scaling, index_streams=streams,
        exclude=[k for k in sizes if k not in streams],
    )
    logger.log(
        "final",
        teacher_accuracy=tacc,
        student_quantized_accuracy=sacc,
        size_mb=rep.total_mb,
        compression_ratio=rep.compression_ratio,
        data_source=train_ds.source,
    )
    mgr.record_run(
        sname, "quantized_distillation", config,
        {"accuracy": sacc, "teacher_accuracy": tacc,
         "compression_ratio": rep.compression_ratio},
    )
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
