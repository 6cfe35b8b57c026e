"""High-level training loops (PyTorch port of the JAX package's
``train/loops.py``): ``fit`` runs the epoch loop around the train step,
with periodic evaluation on hard-quantized weights and metrics logging;
``evaluate`` aggregates eval metrics over a dataset. Both thread a
recurrent carry for stateful tasks (contiguous-BPTT LM,
``tasks.lm_task(thread_carry=True)``). ``fit`` checkpoints the train
state through a :class:`.manager.ExperimentManager` after each epoch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from ..config import TrainConfig
from ..utils.metrics import MetricsLogger, Throughput
from .trainer import (
    Task,
    TrainState,
    build_optimizer,
    make_eval_step,
    make_train_step,
    map_tensors,
)

Batch = Dict[str, np.ndarray]


def evaluate(eval_step, state: TrainState, batches: Iterable[Batch],
             initial_carry=None) -> Dict[str, float]:
    """Aggregate eval metrics over a dataset: means weighted by batch size;
    ``nll_sum``/``n_tokens`` pairs (NMT, LM) summed and reported as
    perplexity, as the reference evaluates perplexity.

    ``initial_carry``: recurrent state threaded across batches for stateful
    tasks (contiguous-BPTT LM eval), handed in as ``batch["carry"]`` and
    replaced by the ``"carry"`` the eval step returns in its metrics."""
    sums: Dict[str, float] = {}
    weights: Dict[str, float] = {}
    carry = initial_carry
    for batch in batches:
        batch = {k: v for k, v in batch.items() if k != "index"}
        bs = next(iter(batch.values())).shape[0]
        if carry is not None:
            batch["carry"] = carry
        m = dict(eval_step(state, batch))
        new_carry = m.pop("carry", None)
        if initial_carry is not None and new_carry is not None:
            carry = new_carry
        for k, v in m.items():
            v = float(v)
            if k in ("nll_sum", "n_tokens"):
                sums[k] = sums.get(k, 0.0) + v
                weights[k] = 1.0
            else:
                sums[k] = sums.get(k, 0.0) + v * bs
                weights[k] = weights.get(k, 0.0) + bs
    out = {k: sums[k] / weights[k] for k in sums}
    if "nll_sum" in out and "n_tokens" in out and out["n_tokens"] > 0:
        out["perplexity"] = math.exp(min(out["nll_sum"] / out["n_tokens"], 30.0))
        del out["nll_sum"], out["n_tokens"]
    return out


def fit(
    task: Task,
    state: TrainState,
    cfg: TrainConfig,
    train_batches: Callable[[int], Iterable[Batch]],
    *,
    eval_batches: Optional[Callable[[], Iterable[Batch]]] = None,
    tx=None,
    mode: str = "weights",
    bits_map: Optional[Dict[str, int]] = None,
    logger: Optional[MetricsLogger] = None,
    manager=None,
    model_name: Optional[str] = None,
    item_count: Callable[[Batch], int] = lambda b: next(iter(b.values())).shape[0],
    carry_reset=None,
    device="cuda",
) -> TrainState:
    """Epoch loop: ``train_batches(epoch)`` yields numpy batches; evaluate
    on hard-quantized weights every ``cfg.eval_every`` steps and after each
    epoch; log train metrics every ``cfg.log_every`` steps; with a
    ``manager`` and a ``model_name``, save the state after each epoch.

    ``carry_reset``: for stateful (carry-threading) tasks, the zero carry
    installed afresh at each epoch's start (the data stream restarts) and
    the initial carry of every eval pass. It is copied once, so the
    caller's tensors stay as they are; the train step copies it into its
    carry buffer and never writes it."""
    logger = logger or MetricsLogger(echo=False)
    tx = tx or build_optimizer(cfg)
    step_fn = make_train_step(
        task, tx, quant=cfg.quant, distill=cfg.distill, mode=mode, bits_map=bits_map,
        device=device,
    )
    eval_fn = make_eval_step(task, quant=cfg.quant, bits_map=bits_map, device=device)
    if carry_reset is not None:
        carry_reset = map_tensors(lambda t: t.detach().clone(), carry_reset)
    thr = Throughput()
    for epoch in range(cfg.epochs):
        if carry_reset is not None:
            state = state.replace(carry=carry_reset)
        losses = []
        for batch in train_batches(epoch):
            batch = {k: v for k, v in batch.items() if k != "index"}
            n = item_count(batch)
            state, metrics = step_fn(state, batch, cfg.seed)
            losses.append(float(metrics["loss"]))
            thr.add(n)
            step = state.step
            if cfg.log_every and step % cfg.log_every == 0:
                logger.log("train", step=step, epoch=epoch, items_per_s=thr.per_second,
                           **{k: float(v) for k, v in metrics.items()})
            if cfg.eval_every and eval_batches is not None and step % cfg.eval_every == 0:
                logger.log("eval", step=step, epoch=epoch,
                           **evaluate(eval_fn, state, eval_batches(), carry_reset))
        epoch_metrics: Dict[str, float] = {"loss": float(np.mean(losses))}
        if eval_batches is not None:
            epoch_metrics.update(evaluate(eval_fn, state, eval_batches(), carry_reset))
        logger.log("epoch", step=state.step, epoch=epoch, **epoch_metrics)
        if manager is not None and model_name is not None:
            manager.save(model_name, state, state.step)
    return state
