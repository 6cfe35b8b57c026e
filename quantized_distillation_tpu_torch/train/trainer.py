"""Knowledge-distillation trainer with fake-quant STE weights (PyTorch port
of the JAX package's ``train/trainer.py``).

One train step does what the JAX package compiles into one ``jit``:
fake-quantize the student's quantizable weights with a straight-through
gradient (one fake-quant kernel launch per bits-group on the card), run the
student on them, run the teacher without gradients, take the KD loss and
its gradients on the full-precision master weights, and step the optimizer
on those.

On the card the step is one CUDA graph, as the JAX package's is one
``jax.jit(step_fn, donate_argnums=(0,))``. It is split in two.
``prepare`` is the host's work: the step's seeds, the learning rate and
Adam's bias corrections (written into a small device tensor), the batch
copied into static input buffers and the incoming carry into the step's
carry buffer. ``body`` is the device's: it reads only those buffers and
the state's tensors, and writes the parameters, codebooks, moments,
running statistics and carry in place and the metrics into static
outputs. The first call for a signature (the state's tensors by address,
shape and dtype; the batch's shapes and dtypes; the TF32 settings) runs
``body`` as the warm-up of a capture (``utils.graphs.CapturedStep``): the
warm-up is that call's step, and the capture after it only records. Later
calls run ``prepare`` and replay. A failed capture raises; nothing runs
eagerly in its place. On the CPU, and with ``_eager=True`` on the card,
``prepare`` and ``body`` run eagerly. Under a profiler a call is the span
``train.step`` around ``train.prepare``, the graph's ``graph.replay`` (or
capture) and ``train.finish`` (``utils.tracing``).

``donate=True`` (the default, as in JAX) steps the caller's state in
place, so neither keeps the old weights; ``donate=False`` leaves the
caller's tensors as they were and returns a state of new tensors (the
step steps a copy of its own). The metrics and the carry come back as new
tensors either way, as JAX returns new arrays.

Random numbers: the JAX step folds the step count into its key and splits
it in two (weight quantization, dropout); here two ``torch.Generator``s
that the step keeps on its device are seeded before each step from
``(rng, step, 0)`` and ``(rng, step, 1)`` (a graph reads their seeds at
each replay, so its draws are the eager step's). They cannot give JAX's
bits.

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

A step with a ``mesh`` (data or tensor parallel) is graphed as the
one-card step is, one CUDA graph per signature, when the mesh's group is
NCCL's and the step runs on the card (``parallel.comm.capturable``): its
collectives, the gradient all-reduce in ``grad_reduce_dtype`` and those
the tensor-parallel operators issue in autograd's backward among them, are
captured and replayed with the step's kernels, as the JAX package's mesh
step is one ``jax.jit`` whatever its mesh. ``parallel.comm.warm_up``
creates the communicators before the first capture, and the mesh's
process groups are part of a signature, so a graph never outlives nor
reuses another group's communicator. A gloo group's collectives go
through the host and cannot be captured: such a step runs eagerly, by
its backend, on the card as on the CPU. A failed capture on an NCCL mesh
raises; nothing falls back to eager.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import DistillSpec, QuantSpec, TrainConfig
from ..parallel.comm import capturable, pmean, psum, warm_up
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size
from ..parallel.tensor import ModelParallel
from ..utils.graphs import CapturedStep, GraphCache, precision_key, signature
from ..utils.tracing import count, span
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


def step_seeds(rng: int, step: int, data_index: Optional[int] = None) -> Tuple[int, int]:
    """(weight quantization, dropout) seeds of train step ``step``; with
    ``data_index`` (a data-parallel rank's coordinate) the dropout seed is
    folded with it, the quantization one is not."""
    seeds = [int(s) for s in np.random.SeedSequence([rng, step]).generate_state(2, np.uint64)]
    if data_index is not None:
        seeds[1] = int(np.random.SeedSequence([seeds[1], data_index]).generate_state(1, np.uint64)[0])
    return seeds[0], seeds[1]


def step_generators(device: torch.device, rng: int, step: int,
                    data_index: Optional[int] = None):
    """New (weight quantization, dropout) generators seeded with
    :func:`step_seeds`."""
    return tuple(torch.Generator(device=device).manual_seed(s)
                 for s in step_seeds(rng, step, data_index))


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


def _leaves(tree) -> list:
    out = []
    map_tensors(out.append, tree)
    return out


def _copy_into(dst, src) -> None:
    """Every tensor of ``src`` into the tensor at its place in ``dst`` (two
    trees of one structure), skipping a tensor that is its own target."""
    with torch.no_grad():
        for d, t in zip(_leaves(dst), _leaves(src), strict=True):
            if d is not t:
                d.copy_(t, non_blocking=True)


def _state_tensors(state: TrainState) -> list:
    """The tensors a step reads and writes in place, in a fixed order."""
    opt = state.opt_state
    return _leaves([state.params, opt.mu, opt.nu, state.batch_stats, state.codebooks])


def _tree_key(tree, by_address: bool):
    """A hashable key of a tree of dicts, tuples and lists of tensors: its
    structure and every tensor's shape, dtype and device (and address, with
    ``by_address``: ``utils.graphs.signature``)."""
    if isinstance(tree, dict):
        return tuple((k, _tree_key(v, by_address)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree),) + tuple(_tree_key(v, by_address) for v in tree)
    if isinstance(tree, torch.Tensor):
        return signature(tree) if by_address else (tuple(tree.shape), tree.dtype, tree.device)
    return tree


def _clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` in new tensors (each keeps ``requires_grad``)."""

    def clone(t):
        return t.detach().clone().requires_grad_(t.requires_grad)

    opt = state.opt_state
    return state.replace(
        params=map_tensors(clone, state.params), batch_stats=map_tensors(clone, state.batch_stats),
        codebooks=map_tensors(clone, state.codebooks), carry=map_tensors(clone, state.carry),
        opt_state=opt._replace(mu=map_tensors(clone, opt.mu), nu=map_tensors(clone, opt.nu)))


@dataclass
class StepRun:
    """One signature's buffers: what :meth:`TrainStep.prepare` writes and
    :meth:`TrainStep.body` reads and writes. ``state`` is the state the
    body steps in place (the caller's, or with ``donate=False`` the step's
    own copy); ``batch`` and ``carry`` the inputs (a graph's static ones,
    or eagerly the call's own tensors); ``hyper`` the optimizer's host
    values (``Optimizer.hyper_values``); ``metrics`` and ``carry_out`` the
    static outputs, made by the first body."""

    batch: Dict[str, torch.Tensor]
    carry: Any
    hyper: torch.Tensor
    generators: Tuple[torch.Generator, torch.Generator]
    state: TrainState
    metrics: Optional[Dict[str, torch.Tensor]] = None
    carry_out: Any = None
    graph: Optional[CapturedStep] = None


class TrainStep:
    """The train step ``(state, batch, rng: int) -> (state, metrics)`` that
    :func:`make_train_step` builds (see the module docstring):
    :meth:`prepare` (host), then :meth:`body` (device: :meth:`gradients`,
    then :meth:`update`), captured as one CUDA graph per signature on the
    card and replayed after, then :meth:`finish`. ``captures`` counts the graphs captured; at
    most ``SIZE`` signatures are kept, the least recently used dropped
    first."""

    SIZE = GraphCache.SIZE

    def __init__(self, task, tx, *, quant, distill, mode, bits_map, mesh, reduce_dtype, mp,
                 donate, eager, device):
        self.task, self.tx, self.quant, self.distill = task, tx, quant, distill
        self.mode, self.bits_map, self.mesh, self.reduce_dtype, self.mp = (
            mode, bits_map, mesh, reduce_dtype, mp)
        self.donate, self.device = donate, device
        self.data_index = None if mesh is None else axis_index(mesh, DATA_AXIS)
        # a gloo mesh steps eagerly, by its backend (see the module docstring)
        self.graphed = device.type == "cuda" and not eager and (
            mesh is None or capturable(mesh, device))
        # the key keeps the groups alive: a graph holds their communicators
        self._groups = () if mesh is None else tuple(
            mesh.get_group(axis) for axis in mesh.mesh_dim_names)
        self.captures = 0
        self._runs: OrderedDict = OrderedDict()

    def __call__(self, state: TrainState, batch: Batch, rng: int = 0):
        with span("train.step"):
            with span("train.prepare"):
                run = self.prepare(state, batch, rng)
            if not self.graphed:
                self.body(run)
            elif run.graph is None:
                if self.mesh is not None:
                    warm_up(self.mesh)  # the communicators, before any capture
                # the warm-up is this call's step; the capture only records
                run.graph = CapturedStep(lambda: self.body(run), counted_warmup=True,
                                         generators=run.generators)
                self.captures += 1
            else:
                run.graph.replay()
            with span("train.finish"):
                return self.finish(state, run)

    def prepare(self, state: TrainState, batch: Batch, rng: int = 0) -> StepRun:
        """The host's part of a step: finds (or makes) the signature's
        buffers and writes into them the batch, the carry, the learning rate
        and bias corrections and the generators' seeds; with
        ``donate=False`` copies the state into the step's own."""
        if self.mp is not None and set(state.params) - set(self.mp.specs):
            raise ValueError(f"param_specs lack {sorted(set(state.params) - set(self.mp.specs))}")
        host = {}
        for k, v in batch.items():
            if k != "carry":  # the state's carry is the step's
                t = torch.as_tensor(v)
                host[k] = (t, torch.float32 if t.is_floating_point() else torch.int64)
        key = (self._groups,
               tuple((k, tuple(t.shape), dt) for k, (t, dt) in sorted(host.items())),
               _tree_key(state.carry, False), precision_key(),
               tuple(_tree_key(t, self.donate) for t in _state_tensors(state)))
        run = self._runs.get(key)
        if run is None:
            run = self._new_run(state, host)
            self._runs[key] = run
            while len(self._runs) > self.SIZE:
                self._runs.popitem(last=False)
                count("graph.evictions")
        else:
            self._runs.move_to_end(key)
        if self.graphed:  # into the graph's static inputs
            for k, (t, _) in host.items():
                run.batch[k].copy_(t, non_blocking=True)
            _copy_into(run.carry, state.carry)
        else:  # eagerly, the body reads the batch and the carry where they lie
            run.batch = {k: t.to(self.device, dt, non_blocking=True)
                         for k, (t, dt) in host.items()}
            run.carry = map_tensors(torch.Tensor.detach, state.carry)
        if self.donate:
            run.state = state
        else:
            _copy_into(_state_tensors(run.state), _state_tensors(state))
        hyper = self.tx.hyper_values(state.opt_state.count, self.device)
        run.hyper.copy_(torch.from_numpy(hyper), non_blocking=True)
        for gen, seed in zip(run.generators, step_seeds(rng, state.step, self.data_index)):
            gen.manual_seed(seed)
        return run

    def _new_run(self, state: TrainState, host) -> StepRun:
        dev = self.device

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev) if self.graphed else None

        return StepRun(
            batch={k: empty(t.shape, dt) for k, (t, dt) in host.items()},
            carry=map_tensors(lambda t: empty(t.shape, t.dtype), state.carry),
            hyper=torch.empty(3, dtype=torch.float32, device=dev),
            generators=(torch.Generator(device=dev), torch.Generator(device=dev)),
            state=state if self.donate else _clone_state(state))

    def body(self, run: StepRun) -> None:
        """The device's part of a step: reads only ``run``'s buffers and its
        state's tensors, and writes them in place."""
        self.update(run, *self.gradients(run))

    def gradients(self, run: StepRun):
        """``(loss, metrics, grads, updates)`` of :func:`loss_and_grads` on
        ``run``'s buffers and state, reduced over ``data`` with a mesh."""
        st = run.state
        batch = dict(run.batch)
        if run.carry is not None:
            batch["carry"] = run.carry
        q_gen, drop_gen = run.generators
        loss, metrics, grads, updates = loss_and_grads(
            self.task, st.params, batch, quant=self.quant, distill=self.distill,
            bits_map=self.bits_map, quant_generator=q_gen, dropout_generator=drop_gen,
            codebooks=st.codebooks, mode=self.mode, batch_stats=st.batch_stats,
            model_parallel=self.mp,
        )
        if self.mesh is not None:
            loss, metrics, grads, updates = reduce_over_data(loss, metrics, grads, updates,
                                                             self.mesh, self.reduce_dtype)
        return loss, metrics, grads, updates

    def update(self, run: StepRun, loss, metrics, grads, updates) -> None:
        """The optimizer step on ``run``'s state (in place), the new running
        statistics and carry, and the metrics into the static outputs."""
        st = run.state
        wrt = trainable(st.params, st.codebooks, self.mode)
        norm = global_norm(grads) if self.mp is None else model_parallel_norm(grads, self.mp)
        opt_updates, _ = self.tx.update(grads, st.opt_state, wrt, norm=norm, hyper=run.hyper)
        apply_updates(wrt, opt_updates)
        out = dict(metrics, loss=loss, grad_norm=norm)
        with torch.no_grad():
            if st.batch_stats is not None and "batch_stats" in updates:
                for name, t in st.batch_stats.items():
                    t.copy_(updates["batch_stats"][name])
            if "carry" in updates and run.carry_out is None:
                run.carry_out = map_tensors(lambda t: t.detach().clone(), updates["carry"])
            elif "carry" in updates:
                _copy_into(run.carry_out, updates["carry"])
            if run.metrics is None:
                run.metrics = {k: v.detach().clone() for k, v in out.items()}
            else:
                for k, v in out.items():
                    run.metrics[k].copy_(v)

    def finish(self, state: TrainState, run: StepRun):
        """The state after the step that ``run`` ran from ``state``, and its
        metrics: the metrics and the carry cloned from the static outputs,
        which the next step overwrites."""
        new = state if self.donate else _clone_state(run.state)
        carry = state.carry
        if run.carry_out is not None:
            carry = map_tensors(torch.Tensor.clone, run.carry_out)
        opt = new.opt_state._replace(count=state.opt_state.count + 1)
        metrics = {k: v.clone() for k, v in run.metrics.items()}
        return new.replace(step=state.step + 1, opt_state=opt, carry=carry), metrics


def make_train_step(
    task: Task,
    tx: Optimizer,
    *,
    quant: Optional[QuantSpec] = None,
    distill: Optional[DistillSpec] = None,
    mode: str = "weights",
    donate: bool = True,
    bits_map: Optional[Dict[str, int]] = None,
    mesh=None,
    grad_reduce_dtype=None,
    param_specs: Optional[Mapping[str, tuple]] = None,
    device="cuda",
    _eager: bool = False,
) -> TrainStep:
    """The train step ``(state, batch, rng: int) -> (state, metrics)``, a
    :class:`TrainStep`: one CUDA graph per signature on the card (see the
    module docstring).

    ``metrics`` holds the task's metrics, ``loss`` and ``grad_norm`` (the
    global norm of the trained tensors' gradients before clipping), as 0-dim
    tensors on the device. ``donate=True``: what ``mode`` trains (the master
    weights, the codebooks or both), the optimizer's moments and the running
    statistics are updated in place, and the returned state holds them and
    the new carry. ``donate=False``: the caller's state stays as it was and
    the returned state holds new tensors. ``_eager=True`` runs the step
    without a graph on the card (for comparisons, and for tasks with Python
    side effects, which a replay does not repeat).

    ``mesh`` (a ``parallel.make_mesh`` mesh; one process per rank): data
    parallelism over its ``data`` axis on replicated parameters, each rank
    passing its own rows of the batch (``parallel.place_batch``); see the
    module docstring. ``grad_reduce_dtype`` (requires ``mesh``) carries the
    gradient all-reduce in that dtype (``preferred_grad_reduce_dtype``);
    f32 when None. A step with a mesh is one CUDA graph per signature,
    collectives included, over an NCCL group on the card, and runs eagerly
    over gloo.

    ``param_specs`` (requires ``mesh``; parameter name → partition spec,
    ``parallel.placed_pspecs`` of the whole parameters): the state's
    parameters are this rank's shards under those specs, and the step is
    tensor parallel over ``model`` (see the module docstring). None: every
    parameter whole on every rank, the data-parallel step above."""
    dev = resolve_device(device)
    _check_mode(mode, quant)
    if grad_reduce_dtype is not None and mesh is None:
        raise ValueError("grad_reduce_dtype requires a mesh")
    mp = _model_parallel(mesh, param_specs)
    if mp is not None and not task.model_parallel:
        raise ValueError("this task does not take parameters split over model "
                         "(nmt_task and lm_task do)")
    return TrainStep(task, tx, quant=quant, distill=distill, mode=mode, bits_map=bits_map,
                     mesh=mesh, reduce_dtype=grad_reduce_dtype or torch.float32, mp=mp,
                     donate=donate, eager=_eager, device=dev)


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
    _eager: bool = False,
):
    """Eval step ``(state, batch) -> metrics`` on the deployment
    (hard-quantized, with the state's codebooks for a codebook ``quant``)
    weights and the state's running statistics, as the reference
    evaluates the quantized model, not the full-precision master copy. A
    task that threads a carry returns it as ``metrics["carry"]``
    (``loops.evaluate`` feeds it to the next batch). On the card it runs as
    one CUDA graph per state (its tensors' addresses) and batch and carry
    shapes, as the JAX package's is one ``jax.jit`` (``utils.graphs.
    GraphCache``; ``_eager=True``: without one); the metrics and the carry
    come back as new tensors."""
    dev = resolve_device(device)
    graphs = GraphCache()
    shapes: Dict[Any, Any] = {}  # key → the metrics' tree, its tensors as placeholders

    def evaluate_on(state: TrainState, batch: Dict[str, Any]) -> Dict[str, Any]:
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

    def eval_fn(state: TrainState, batch: Batch) -> Dict[str, Any]:
        batch = as_batch(batch, dev)
        if dev.type == "cpu" or _eager:
            return evaluate_on(state, batch)
        names = sorted(k for k in batch if k != "carry")
        carry = batch.get("carry")
        key = (quant, quantized_eval, tuple(names), _tree_key(carry, False),
               tuple(signature(t) for t in _state_tensors(state)))

        def run(*inputs):
            b = dict(zip(names, inputs))
            if carry is not None:
                it = iter(inputs[len(names):])
                b["carry"] = map_tensors(lambda _: next(it), carry)
            metrics = evaluate_on(state, b)
            shapes[key] = map_tensors(lambda _: torch.empty(0), metrics)
            return tuple(_leaves(metrics))

        out = iter(graphs.run(key, run, [batch[k] for k in names] + _leaves(carry)))
        return map_tensors(lambda _: next(out), shapes[key])

    return eval_fn
