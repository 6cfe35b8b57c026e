"""Knowledge-distillation trainer with fake-quant STE weights (PyTorch port
of the JAX package's ``train/trainer.py``).

One train step does what the JAX package compiles into one ``jit``:
fake-quantize the student's quantizable weights with a straight-through
gradient (one fake-quant kernel launch per bits-group on the card), run the
student on them, run the teacher without gradients, take the KD loss and
its gradients on the full-precision master weights, and step the optimizer
on those. PyTorch runs it eagerly, so the step is a Python function; the
master weights are updated in place (the JAX step donates its state, so
neither keeps the old weights).

Random numbers: the JAX step folds the step count into its key and splits
it in two (weight quantization, dropout); here two ``torch.Generator``s on
the step's device are seeded from ``(rng, step, 0)`` and ``(rng, step,
1)``. They cannot give JAX's bits.

Three modes cover both of the paper's algorithms, as in the JAX package:
``weights`` (quantized distillation: the optimizer steps the master
weights), ``codebooks`` (differentiable quantization: the weights are
frozen and the optimizer steps each leaf's codebook points) and ``joint``
(one optimizer over both: global-norm clip over both, then Adam). The two
codebook modes need ``QuantSpec(method="codebook")``. In ``codebooks``
mode the weights get no gradient (``requires_grad`` off), no update and no
optimizer state. The optimizer sees one name → tensor dict; a codebook's
name is ``CODEBOOK_PREFIX`` + its flax path, which no parameter name can
be (those have no ``/``).

Two more channels carry state from step to step, as in the JAX package:
``TrainState.batch_stats`` (the BatchNorm running statistics of the vision
families, buffer name → tensor) and ``TrainState.carry`` (the LSTM
language model's truncated-BPTT carry). The student runs on the quantized
weights with the state's running statistics (in the mapping handed to
``Task.student_forward``); the statistics the task returns in
``updates["batch_stats"]`` are copied into the state's tensors in place,
as the master weights are updated in place, in every mode (mode
``codebooks`` freezes the weights, not the statistics). The carry goes in
as ``batch["carry"]``, detached, and the task's ``updates["carry"]`` comes
back detached, so no step holds on to the graph of the one before.

Data parallelism (``make_train_step(mesh=..., grad_reduce_dtype=...)``),
one process per rank (see :mod:`..parallel`): each rank steps on its
``data`` slice of the batch (``parallel.place_batch``) with the same
replicated parameters, as the JAX package's reduced-precision path does
under ``shard_map``. The gradients are pre-scaled by the shard's weight
(``n_local / sum n_local`` when the task's metrics carry ``n_tokens``, else
``1 / D``), all-reduced over ``data`` in ``grad_reduce_dtype`` (f32 when
None) in one flat buffer, and cast back to f32 before the optimizer, which
every rank then runs on the same gradients. The loss is reduced with the
same weights; the metrics and the running statistics are averaged; the
carry stays each rank's own. The fake-quant generator is the same on every
rank (every shard sees the same quantized weights), the dropout generator
is folded with the rank's ``data`` coordinate. BatchNorm normalizes with
each shard's own batch statistics, as in the JAX package's
reduced-precision path.

Tensor parallelism (``make_train_step(mesh=, param_specs=)``): the state
holds this rank's shards of the parameters, as
``parallel.place_params_seq2seq`` / ``place_params_lm`` place a model's
``named_parameters()``, and ``param_specs`` says how
(``parallel.placed_pspecs`` of the whole parameters). The task runs the
model's tensor-parallel forward on the shards (``forward_tp``: the JAX
rules' layout over ``model``, its collectives written out in
``parallel/tensor.py``) and the vocab-parallel loss where the logits are
split; the loss, the metrics and each rank's gradients equal the
one-process step's (its slices). Fake-quant gathers the split leaves and
quantizes the whole tree, one launch a bits-group as in the one-process
step (``quantize_tree.ste_quantize_tree_tp``); the global norm sums the
split leaves' squares over ``model``; the gradients are reduced over
``data`` only. The fake-quant generator is the same on every rank and the
dropout one is folded with the ``data`` coordinate, so every rank of
``model`` draws the same whole masks. Learned codebooks
(modes ``codebooks`` and ``joint``) stay whole on every rank: each split
leaf is snapped onto its codebook whole and the points' gradient is summed
over ``model`` (``quantize_tree.ste_codebook_tree_tp``); pass the same
``mesh`` and ``param_specs`` to :func:`create_train_state` so a quantile
init reads the whole leaves. Only tasks built for it (``nmt_task``,
``lm_task``) take split parameters, and the teacher runs whole on every
rank.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import DistillSpec, QuantSpec, TrainConfig
from ..parallel.comm import pmean, psum
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size
from ..parallel.tensor import ModelParallel
from . import quantize_tree as qt
from .optim import (
    OptState,
    Optimizer,
    apply_updates,
    constant_schedule,
    exponential_decay_staircase,
    global_norm,
    model_parallel_norm,
    warmup_cosine_decay_schedule,
)

Params = Dict[str, torch.Tensor]
Batch = Dict[str, Any]

MODES = ("weights", "codebooks", "joint")
CODEBOOK_PREFIX = "codebook:"


@dataclass
class TrainState:
    step: int
    params: Params  # parameter name → full-precision master tensor
    opt_state: OptState
    batch_stats: Optional[Dict[str, torch.Tensor]] = None  # buffer name → running statistic
    codebooks: Optional[Dict[str, torch.Tensor]] = None  # flax path → [2^bits] points
    carry: Any = None  # recurrent state threaded across steps (detached)

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Task:
    """What the trainer needs to know about a workload.

    ``student_forward(params, batch, train, generator) -> (logits, updates)``
    runs the student on ``params`` (parameter names → tensors, with the
    running statistics under their buffer names where the state has them);
    ``updates`` may hold new ``batch_stats`` and a new ``carry``, and is
    ``{}`` for seq2seq;
    ``teacher_forward(batch) -> logits`` runs the teacher without gradients;
    ``loss_and_metrics(student_logits, teacher_logits, batch, distill)``
    returns ``(scalar loss, metrics dict)``. ``model_parallel``: both
    callables also take ``model_parallel=`` (a
    ``parallel.tensor.ModelParallel``: the student's parameters are one
    rank's shards), as ``nmt_task`` and ``lm_task`` build them."""

    student_forward: Callable[..., Tuple[torch.Tensor, Dict]]
    loss_and_metrics: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    teacher_forward: Optional[Callable[[Batch], torch.Tensor]] = None
    model_parallel: bool = False


def build_optimizer(cfg: TrainConfig, steps_per_epoch: int = 1) -> Optimizer:
    """Optimizer + learning-rate schedule, as the JAX package builds them
    from optax (see :mod:`.optim`). It makes no tensor: ``init(params)``
    puts its state on the parameters' device."""
    total_steps = max(cfg.epochs * steps_per_epoch, 1)
    if cfg.lr_schedule == "cosine":
        sched = warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, max(cfg.warmup_steps, 1), total_steps
        )
    elif cfg.lr_schedule == "step":
        every = cfg.lr_decay_every or steps_per_epoch
        sched = exponential_decay_staircase(cfg.learning_rate, every, cfg.lr_decay_rate)
    else:
        sched = constant_schedule(cfg.learning_rate)
    return Optimizer(cfg.optimizer, sched, cfg.clip_norm, cfg.weight_decay)


def _check_mode(mode: str, quant: Optional[QuantSpec]) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown train mode {mode!r}; expected one of {MODES}")
    if mode != "weights" and (quant is None or quant.method != "codebook"):
        raise ValueError(f"mode {mode!r} trains codebooks: it needs QuantSpec(method='codebook')")


def trainable(params: Params, codebooks: Optional[Dict[str, torch.Tensor]],
              mode: str) -> Dict[str, torch.Tensor]:
    """What the optimizer steps in ``mode``, as one name → tensor dict: the
    parameters, the codebooks (under ``CODEBOOK_PREFIX`` + flax path), or
    both."""
    books = {CODEBOOK_PREFIX + p: t for p, t in (codebooks or {}).items()}
    if mode == "weights":
        return dict(params)
    if mode == "codebooks":
        return books
    return {**params, **books}


def map_tensors(fn, tree):
    """``fn`` on every tensor of a tree of dicts, tuples and lists (None and
    other leaves kept)."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _on(dev: torch.device, t: torch.Tensor, what: str) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, not {dev}")
    return t


def create_train_state(
    params: Mapping[str, torch.Tensor],
    tx: Optimizer,
    *,
    batch_stats: Optional[Mapping[str, torch.Tensor]] = None,
    quant: Optional[QuantSpec] = None,
    codebook_init: str = "uniform",
    mode: str = "weights",
    carry: Any = None,
    mesh=None,
    param_specs: Optional[Mapping[str, tuple]] = None,
    device="cuda",
) -> TrainState:
    """Train state over ``params`` (``dict(model.named_parameters())``),
    trained in place, so the model that owns them is the one trained: their
    gradients are turned on, or off in mode ``codebooks``. ``batch_stats``
    (``dict(model.named_buffers())``: the running statistics) are updated in
    place too. ``carry`` (a tree of tensors, e.g. from
    :func:`.tasks.lm_initial_carry`) is copied, so the caller's stays as it
    is. A codebook ``quant`` adds one codebook per quantizable leaf
    (``codebook_init``: ``uniform`` or ``quantile``); with ``mesh`` and
    ``param_specs`` (as :func:`make_train_step` takes them) ``params`` are
    one rank's shards and the quantiles are those of the whole leaves.
    Every tensor must be on ``device``."""
    dev = resolve_device(device)
    _check_mode(mode, quant)
    params = dict(params)
    for name, p in params.items():
        _on(dev, p, f"parameter {name}").requires_grad_(mode != "codebooks")
    if batch_stats is not None:
        batch_stats = {n: _on(dev, t, f"running statistic {n}") for n, t in batch_stats.items()}
    carry = map_tensors(lambda t: _on(dev, t, "a carry tensor").detach().clone(), carry)
    codebooks = None
    if quant is not None and quant.method == "codebook":
        codebooks = qt.init_codebook_tree(params, quant, codebook_init,
                                          _model_parallel(mesh, param_specs))
        for t in codebooks.values():
            t.requires_grad_(mode != "weights")
    return TrainState(step=0, params=params, batch_stats=batch_stats, codebooks=codebooks,
                      carry=carry, opt_state=tx.init(trainable(params, codebooks, mode)))


def quantized_params(
    params: Params,
    quant: Optional[QuantSpec],
    codebooks: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    bits_map: Optional[Dict[str, int]] = None,
    model_parallel: Optional[ModelParallel] = None,
) -> Params:
    """STE fake-quant view of the parameters (identity when quant is None;
    onto ``codebooks`` for a codebook ``quant``; of one rank's shards with
    ``model_parallel``)."""
    if quant is None:
        return params
    if quant.method == "codebook":
        if codebooks is None:
            raise ValueError("codebook method requires codebooks")
        if model_parallel is not None:
            return qt.ste_codebook_tree_tp(params, codebooks, quant, model_parallel)
        return qt.ste_codebook_tree(params, codebooks, quant)
    if model_parallel is not None:
        return qt.ste_quantize_tree_tp(params, quant, model_parallel, generator, bits_map)
    return qt.ste_quantize_tree(params, quant, generator, bits_map)


def as_batch(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors → tensors on ``device``: integers as int64
    (they index embeddings and gather labels), floats as f32. A ``carry``
    (a tree of tensors) passes through as it is."""
    out = {}
    for k, v in batch.items():
        if k == "carry":
            out[k] = v
            continue
        t = torch.as_tensor(v)
        t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)
        out[k] = t.to(device, non_blocking=True)
    return out


def step_generators(device: torch.device, rng: int, step: int,
                    data_index: Optional[int] = None):
    """(weight quantization, dropout) generators of train step ``step``;
    with ``data_index`` (a data-parallel rank's coordinate) the dropout
    generator is folded with it, the quantization one is not."""
    seeds = [int(s) for s in np.random.SeedSequence([rng, step]).generate_state(2, np.uint64)]
    if data_index is not None:
        seeds[1] = int(np.random.SeedSequence([seeds[1], data_index]).generate_state(1, np.uint64)[0])
    return tuple(torch.Generator(device=device).manual_seed(s) for s in seeds)


def _pmean_dict(tree: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Every tensor of a name → tensor dict averaged over ``data``, in one
    f32 all-reduce."""
    if not tree:
        return tree
    names = list(tree)
    flat = torch.cat([tree[n].detach().to(torch.float32).reshape(-1) for n in names])
    parts = pmean(flat, mesh, DATA_AXIS).split([tree[n].numel() for n in names])
    return {n: p.reshape(tree[n].shape).to(tree[n].dtype) for n, p in zip(names, parts)}


def reduce_over_data(loss, metrics, grads, updates, mesh, reduce_dtype):
    """The data-parallel reduction of one step's ``(loss, metrics, grads,
    updates)`` (the JAX package's ``_reduced_precision_grads``): shard
    weights from ``n_tokens`` (else 1/D), the gradients summed in
    ``reduce_dtype`` in one flat buffer and returned in f32, the loss summed
    with the same weights, metrics and ``batch_stats`` averaged, the carry
    kept."""
    if "n_tokens" in metrics:
        # masked sequence loss: the global token mean weights each shard by
        # its live tokens
        n_local = metrics["n_tokens"].detach().to(torch.float32)
        w = n_local / psum(n_local, mesh, DATA_AXIS)
    else:
        w = 1.0 / axis_size(mesh, DATA_AXIS)
    names = list(grads)
    flat = torch.cat([(grads[n].to(torch.float32) * w).reshape(-1) for n in names])
    flat = psum(flat, mesh, DATA_AXIS, dtype=reduce_dtype)
    grads = {n: g.reshape(grads[n].shape)
             for n, g in zip(names, flat.split([grads[n].numel() for n in names]))}
    loss = psum(loss * w, mesh, DATA_AXIS)
    metrics = _pmean_dict(dict(metrics), mesh)
    updates = dict(updates)
    if "batch_stats" in updates:
        updates["batch_stats"] = _pmean_dict(updates["batch_stats"], mesh)
    return loss, metrics, grads, updates


def loss_and_grads(
    task: Task,
    params: Params,
    batch: Dict[str, torch.Tensor],
    *,
    quant: Optional[QuantSpec] = None,
    distill: Optional[DistillSpec] = None,
    bits_map: Optional[Dict[str, int]] = None,
    quant_generator: Optional[torch.Generator] = None,
    dropout_generator: Optional[torch.Generator] = None,
    codebooks: Optional[Dict[str, torch.Tensor]] = None,
    mode: str = "weights",
    batch_stats: Optional[Dict[str, torch.Tensor]] = None,
    model_parallel: Optional[ModelParallel] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Params, Dict[str, Any]]:
    """The JAX step's ``value_and_grad`` of its loss: ``(loss, metrics,
    grads, updates)`` with ``grads`` keyed like :func:`trainable` (zeros
    where the loss does not reach a tensor, as ``jax.grad`` gives) and
    ``updates`` the task's (new ``batch_stats``, ``carry``). The student
    runs with the running statistics ``batch_stats``. In mode ``codebooks``
    the weights are detached, as the JAX step stops their gradient. With
    ``model_parallel`` the parameters are this rank's shards and the
    gradients are theirs (the task must take split parameters)."""
    if mode == "codebooks":
        params = {n: t.detach() for n, t in params.items()}
    q_params = quantized_params(params, quant, codebooks, quant_generator, bits_map,
                                model_parallel)
    kw = {} if model_parallel is None else {"model_parallel": model_parallel}
    logits, updates = task.student_forward({**q_params, **(batch_stats or {})}, batch, True,
                                           dropout_generator, **kw)
    teacher_logits = task.teacher_forward(batch) if task.teacher_forward else None
    loss, metrics = task.loss_and_metrics(logits, teacher_logits, batch, distill, **kw)
    wrt = trainable(params, codebooks, mode)
    names = list(wrt)
    grads = torch.autograd.grad(loss, [wrt[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(wrt[n]) if g is None else g for n, g in zip(names, grads)}
    return loss.detach(), metrics, grads, updates


def make_train_step(
    task: Task,
    tx: Optimizer,
    *,
    quant: Optional[QuantSpec] = None,
    distill: Optional[DistillSpec] = None,
    mode: str = "weights",
    bits_map: Optional[Dict[str, int]] = None,
    mesh=None,
    grad_reduce_dtype=None,
    param_specs: Optional[Mapping[str, tuple]] = None,
    device="cuda",
):
    """The train step ``(state, batch, rng: int) -> (state, metrics)``.

    ``metrics`` holds the task's metrics, ``loss`` and ``grad_norm`` (the
    global norm of the trained tensors' gradients before clipping), as 0-dim
    tensors on the device. What ``mode`` trains (the master weights, the
    codebooks or both) and the running statistics are updated in place; the
    returned state holds the new carry.

    ``mesh`` (a ``parallel.make_mesh`` mesh; one process per rank): data
    parallelism over its ``data`` axis on replicated parameters, each rank
    passing its own rows of the batch (``parallel.place_batch``); see the
    module docstring. ``grad_reduce_dtype`` (requires ``mesh``) carries the
    gradient all-reduce in that dtype (``preferred_grad_reduce_dtype``);
    f32 when None.

    ``param_specs`` (requires ``mesh``; parameter name → partition spec,
    ``parallel.placed_pspecs`` of the whole parameters): the state's
    parameters are this rank's shards under those specs, and the step is
    tensor parallel over ``model`` (see the module docstring). None: every
    parameter whole on every rank, the data-parallel step above."""
    dev = resolve_device(device)
    _check_mode(mode, quant)
    if grad_reduce_dtype is not None and mesh is None:
        raise ValueError("grad_reduce_dtype requires a mesh")
    reduce_dtype = grad_reduce_dtype or torch.float32
    data_index = None if mesh is None else axis_index(mesh, DATA_AXIS)
    mp = _model_parallel(mesh, param_specs)
    if mp is not None and not task.model_parallel:
        raise ValueError("this task does not take parameters split over model "
                         "(nmt_task and lm_task do)")

    def step_fn(state: TrainState, batch: Batch, rng: int = 0):
        batch = as_batch(batch, dev)
        if state.carry is not None:
            batch["carry"] = map_tensors(torch.Tensor.detach, state.carry)
        q_gen, drop_gen = step_generators(dev, rng, state.step, data_index)
        if mp is not None and set(state.params) - set(mp.specs):
            raise ValueError(f"param_specs lack {sorted(set(state.params) - set(mp.specs))}")
        loss, metrics, grads, updates = loss_and_grads(
            task, state.params, batch, quant=quant, distill=distill, bits_map=bits_map,
            quant_generator=q_gen, dropout_generator=drop_gen, codebooks=state.codebooks,
            mode=mode, batch_stats=state.batch_stats, model_parallel=mp,
        )
        if mesh is not None:
            loss, metrics, grads, updates = reduce_over_data(loss, metrics, grads, updates,
                                                             mesh, reduce_dtype)
        wrt = trainable(state.params, state.codebooks, mode)
        if mp is None:
            opt_updates, opt_state = tx.update(grads, state.opt_state, wrt)
            norm = global_norm(grads)
        else:
            norm = model_parallel_norm(grads, mp)
            opt_updates, opt_state = tx.update(grads, state.opt_state, wrt, norm=norm)
        apply_updates(wrt, opt_updates)
        metrics = dict(metrics, loss=loss, grad_norm=norm)
        if state.batch_stats is not None and "batch_stats" in updates:
            with torch.no_grad():
                for name, t in state.batch_stats.items():
                    t.copy_(updates["batch_stats"][name])
        carry = state.carry
        if "carry" in updates:
            carry = map_tensors(torch.Tensor.detach, updates["carry"])
        return state.replace(step=state.step + 1, opt_state=opt_state, carry=carry), metrics

    return step_fn


def _model_parallel(mesh, param_specs) -> Optional[ModelParallel]:
    """The :class:`ModelParallel` of ``param_specs`` on ``mesh``, or None
    for whole parameters (no specs, or none splits anything over
    ``model``)."""
    if param_specs is None:
        return None
    if mesh is None:
        raise ValueError("param_specs requires a mesh")
    specs = {n: tuple(s) for n, s in param_specs.items()}
    return ModelParallel(mesh, specs) if any(MODEL_AXIS in s for s in specs.values()) else None


def preferred_grad_reduce_dtype(device="cuda") -> torch.dtype:
    """The reduced-precision gradient all-reduce dtype for ``device``: bf16
    on the card (NCCL reduces it; f32's exponent range, so the cast cannot
    overflow), f16 on the CPU, as the JAX package picks on its CPU backend
    (both put 2 bytes an element on the wire)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float16


def make_eval_step(
    task: Task,
    *,
    quant: Optional[QuantSpec] = None,
    quantized_eval: bool = True,
    bits_map: Optional[Dict[str, int]] = None,
    device="cuda",
):
    """Eval step ``(state, batch) -> metrics`` on the deployment
    (hard-quantized, with the state's codebooks for a codebook ``quant``)
    weights and the state's running statistics, as the reference evaluates
    the quantized model, not the full-precision master copy. A task that
    threads a carry returns it as ``metrics["carry"]`` (``loops.evaluate``
    feeds it to the next batch)."""
    dev = resolve_device(device)

    def eval_fn(state: TrainState, batch: Batch) -> Dict[str, Any]:
        batch = as_batch(batch, dev)
        with torch.no_grad():
            params = state.params
            if quant is not None and quantized_eval:
                params = qt.quantize_tree_hard(params, quant, state.codebooks, bits_map)
            logits, updates = task.student_forward({**params, **(state.batch_stats or {})},
                                                   batch, False, None)
            _, metrics = task.loss_and_metrics(logits, None, batch, None)
        if "carry" in updates:
            metrics = dict(metrics, carry=updates["carry"])
        return metrics

    return eval_fn
