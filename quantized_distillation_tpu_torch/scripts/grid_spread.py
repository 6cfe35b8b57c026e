"""The CNN accuracy grid run several times, with the train step graphed and
eager in turns: how far two runs of one kind part, against how far the
kinds part.

    python -m quantized_distillation_tpu_torch.scripts.grid_spread --runs 6

Each run is ``scripts.accuracy_grid --skip-nmt`` in this process, at the
JAX script's defaults or with the further flags given (the grid's); the
runs alternate graph, eager, eager, graph, graph, eager, ... (eager:
``make_train_step(..., _eager=True)`` in ``train.loops.fit``). Prints one JSON line a run: its kind, the teacher's
accuracy, the cells and the contract checks. On the card cuDNN's backward
adds with atomics in no fixed order, so two runs of one kind already part;
that spread is the yardstick for a difference between the kinds.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import sys

from ..train import loops, trainer
from . import accuracy_grid


@contextlib.contextmanager
def eager_steps():
    """Inside, ``fit`` builds its train step with ``_eager=True``."""
    graphed = loops.make_train_step
    loops.make_train_step = functools.partial(trainer.make_train_step, _eager=True)
    try:
        yield
    finally:
        loops.make_train_step = graphed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    args, grid_flags = ap.parse_known_args(argv)
    for i in range(args.runs):
        kind = "graph" if i % 4 in (0, 3) else "eager"
        buf = io.StringIO()
        with contextlib.ExitStack() as stack:
            if kind == "eager":
                stack.enter_context(eager_steps())
            stack.enter_context(contextlib.redirect_stdout(buf))
            accuracy_grid.main(["--skip-nmt", *grid_flags])
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        cnn = out["cnn_synthetic_cifar100"]
        print(json.dumps({"run": i, "kind": kind, "teacher_acc": cnn["teacher_acc"],
                          "cells": cnn["cells"], "contract_checks": out["contract_checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
