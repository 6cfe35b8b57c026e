"""The port's data- and tensor-parallel train steps (``make_train_step(mesh=,
grad_reduce_dtype=, param_specs=)``) over several Adam steps, in the form
the card captures as one CUDA graph per signature over NCCL.

On the CPU, two gloo ranks (``parallel.launch.run_ranks``, one spawn) take
four Adam steps with global-norm clipping and a learning rate halved every
step (``tests/test_torch_train_graph.py``'s schedule, so a learning rate or
a bias correction frozen at its first value shows by step 2), on a
seq2seq student distilled from a teacher (dropout 0), in four legs:

- ``dp_f32`` and ``dp_bf16``: mesh (2, 1), the gradients all-reduced over
  ``data`` in f32 and in bf16 (the card's reduce dtype; gloo reduces bf16
  too), the shards weighted by their live tokens (the targets' masks
  differ shard to shard);
- ``tp_weights`` and ``tp_joint``: mesh (1, 2), the parameters split over
  ``model`` (``place_params_seq2seq``), mode ``weights`` (4-bit STE) and
  mode ``joint`` (2-bit learned codebooks, whole on every rank).

Each rank's parameters (its shards), codebooks and every step's loss,
``grad_norm`` and metrics equal the port's one-process steps, written out
here over the data shards with the reduce's rounding (each rank's
weighted gradients cast to the reduce dtype and summed in it), and their
slices; the f32 legs also equal the JAX package's one-process
``make_train_step(donate=False)`` on the same weights and batches. The
tolerances are ``tests/test_torch_train_graph.py``'s: losses and metrics
rtol 1e-5; parameters and codebooks rtol 1e-5, atol 1e-6. The port's
mesh step averages its metrics over ``data``, so its ``nll_sum`` and
``n_tokens`` are the shards' mean: D of them are the JAX step's sums.

A gloo mesh is never captured (``parallel.comm.capturable`` is false for
it, on the card as on the CPU), so every rank steps eagerly.

Tests marked ``gpu`` run on the card in an NCCL group of world size 1
(a file store under ``tmp_path``), mesh (1, 1), where every collective is
still issued, captured and replayed: the graphed DP (bf16 reduce, dropout
0.3), TP (``weights``, ``joint``) and LM TP (carry threaded) steps equal
their eager runs (``_eager=True``) bit for bit, capture once a signature,
launch fake-quant once a replay in the STE legs and never in ``joint``,
and a replayed step records the eager step's collectives. They skip where
PyTorch sees no card; JAX is imported only inside the CPU tests'
fixtures.
"""

import dataclasses
import types
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.convert import (
    flatten_tree,
    fuse_flax_leaves,
    params_from_numpy,
)
from quantized_distillation_tpu_torch.kernels import fake_quant_buckets
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig, make_lm, make_seq2seq
from quantized_distillation_tpu_torch.parallel import (
    DATA_AXIS,
    ModelParallel,
    make_mesh,
    place_batch,
    place_params_seq2seq,
    placed_pspecs,
)
from quantized_distillation_tpu_torch.parallel.comm import capturable, collective_budget
from quantized_distillation_tpu_torch.parallel.launch import run_ranks
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    lm_initial_carry,
    lm_task,
    make_train_step,
    nmt_task,
)
from quantized_distillation_tpu_torch.train import quantize_tree as qt
from quantized_distillation_tpu_torch.train.optim import apply_updates, global_norm
from quantized_distillation_tpu_torch.train.trainer import (
    _clone_state,
    _leaves,
    as_batch,
    loss_and_grads,
    step_generators,
    trainable,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")
V, B, STEPS = 40, 4, 4
LOSS_RTOL = 1e-5
W_RTOL, W_ATOL = 1e-5, 1e-6
# Adam, clipped, the learning rate halved every step
ADAM = dict(optimizer="adam", learning_rate=1e-3, clip_norm=1e-5, lr_schedule="step",
            lr_decay_every=1, lr_decay_rate=0.5)
DISTILL = (0.5, 2.0)
SUM_METRICS = ("nll_sum", "n_tokens")
LEGS = {
    "dp_f32": dict(mesh=(2, 1), reduce=torch.float32, mode="weights"),
    "dp_bf16": dict(mesh=(2, 1), reduce=torch.bfloat16, mode="weights"),
    "tp_weights": dict(mesh=(1, 2), reduce=torch.float32, mode="weights", tp=True),
    "tp_joint": dict(mesh=(1, 2), reduce=torch.float32, mode="joint", tp=True),
}
JAX_LEGS = ("dp_f32", "tp_weights", "tp_joint")  # an f32 reduce: the one-process step's sums


def _nmt_batch(seed, b=B, ts=5, tt=4):
    """Row 1 misses its last target, so the two data shards of a batch of 4
    weigh 7 and 8 tokens."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, tt), np.float32)
    mask[1, -1] = 0.0
    return {
        "src": rng.integers(4, V, (b, ts)).astype(np.int32),
        "src_len": np.array([ts, ts - 2, 1, ts - 1][:b], np.int32),
        "tgt_in": rng.integers(1, V, (b, tt)).astype(np.int32),
        "tgt_out": rng.integers(1, V, (b, tt)).astype(np.int32),
        "tgt_mask": mask,
    }


def _quant(mode):
    return QuantSpec(bits=4) if mode == "weights" else QuantSpec(bits=2, method="codebook")


def _rows(batch, d, dp):
    n = next(iter(batch.values())).shape[0] // dp
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def _models(payload):
    """(student, task) on the CPU from the payload's flax weights."""

    def port(cfg, params):
        return Seq2Seq(Seq2SeqConfig(**cfg), device="cpu").load_params(params_from_numpy(params))

    student = port(payload["student_cfg"], payload["student"])
    teacher = port(payload["teacher_cfg"], payload["teacher"])
    return student, nmt_task(student, teacher, device="cpu")


def _np(tree):
    return {n: t.detach().numpy().copy() for n, t in tree.items()}


def _reduced(parts, dtype):
    """What a sum over ``data`` of ``parts`` (one tensor a rank, in rank
    order) gives when carried in ``dtype``: each part cast to it, summed in
    it, returned in f32."""
    acc = parts[0].to(dtype)
    for p in parts[1:]:
        acc = (acc.float() + p.to(dtype).float()).to(dtype)
    return acc.float()


def _reference(payload, leg):
    """The one-process steps of ``leg`` over its ``data`` shards: each
    shard's gradients weighted by its share of the live tokens and summed
    with the reduce's rounding, the metrics averaged, then Adam → (every
    step's metrics, whole parameters, codebooks)."""
    spec = LEGS[leg]
    dp, mode = spec["mesh"][0], spec["mode"]
    student, task = _models(payload)
    quant = _quant(mode)
    params = {n: p.detach().clone().requires_grad_() for n, p in student.named_parameters()}
    books = None
    if mode != "weights":
        books = {p: t.requires_grad_() for p, t in qt.init_codebook_tree(params, quant).items()}
    tx = build_optimizer(TrainConfig(**ADAM))
    wrt = trainable(params, books, mode)
    opt = tx.init(wrt)
    metrics = []
    for i, batch in enumerate(payload["batches"]):
        outs = []
        for d in range(dp):
            q_gen, drop_gen = step_generators(CPU, 0, i, d)
            outs.append(loss_and_grads(task, params, as_batch(_rows(batch, d, dp), CPU),
                                       quant=quant, distill=DistillSpec(*DISTILL),
                                       quant_generator=q_gen, dropout_generator=drop_gen,
                                       codebooks=books, mode=mode))
        tokens = [o[1]["n_tokens"].to(torch.float32) for o in outs]
        total = _reduced(tokens, torch.float32)
        w = [t / total for t in tokens]
        grads = {n: _reduced([o[2][n].to(torch.float32) * wd for o, wd in zip(outs, w)],
                             spec["reduce"]) for n in wrt}
        m = {k: float(_reduced([o[1][k].float() for o in outs], torch.float32) / dp)
             for k in outs[0][1]}
        m["loss"] = float(_reduced([o[0] * wd for o, wd in zip(outs, w)], torch.float32))
        m["grad_norm"] = float(global_norm(grads))
        upd, opt = tx.update(grads, opt, wrt)
        apply_updates(wrt, upd)
        metrics.append(m)
    return {"metrics": metrics, "params": _np(params),
            "codebooks": None if books is None else _np(books)}


def _leg(rank, payload, leg):
    """This rank's four steps of ``leg`` → its metrics, parameters (shards)
    and codebooks, each step's collectives, whether the step was graphed,
    and the reference's and the JAX step's slices beside them."""
    spec = LEGS[leg]
    mesh = make_mesh(*spec["mesh"])
    student, task = _models(payload)
    quant, mode = _quant(spec["mode"]), spec["mode"]
    whole = dict(student.named_parameters())
    specs = placed_pspecs(whole, mesh) if spec.get("tp") else None
    params = place_params_seq2seq(whole, mesh, device="cpu") if specs else whole
    tx = build_optimizer(TrainConfig(**ADAM))
    state = create_train_state(params, tx, quant=quant, mode=mode, mesh=mesh, param_specs=specs,
                               device="cpu")
    step = make_train_step(task, tx, quant=quant, distill=DistillSpec(*DISTILL), mode=mode,
                           mesh=mesh, param_specs=specs, device="cpu",
                           grad_reduce_dtype=None if spec["reduce"] == torch.float32
                           else spec["reduce"])
    metrics, budgets = [], []
    for batch in payload["batches"]:
        with collective_budget(mesh) as budget:
            state, m = step(state, place_batch(batch, mesh, device="cpu"), 0)
        metrics.append({k: float(v) for k, v in m.items()})
        budgets.append([(op.kind, op.bytes, op.axis, op.group_size) for op in budget.ops])
    mp = ModelParallel(mesh, specs or {})
    refs = payload["refs"][leg]

    def local(tree):
        return {n: mp.local(n, torch.from_numpy(np.asarray(t))).numpy() for n, t in tree.items()}

    return {
        "metrics": metrics, "params": _np(state.params),
        "codebooks": None if state.codebooks is None else _np(state.codebooks),
        "budgets": budgets, "graphed": step.graphed, "captures": step.captures,
        "capturable": [capturable(mesh, CPU), capturable(mesh, torch.device("cuda"))],
        "ref_params": local(refs["params"]),
        "jax_params": local(payload["jax"][spec["mode"]]["params"]) if leg in JAX_LEGS else None,
    }


def _rank(rank, world, payload):
    return {leg: _leg(rank, payload, leg) for leg in LEGS}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's one-process steps (modes ``weights`` and ``joint``)
    from the weights of a JAX init, and the payload the ranks build from."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import DistillSpec as JDistill
    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.config import TrainConfig as JTrainConfig
    from quantized_distillation_tpu.models import make_seq2seq as jmake_seq2seq
    from quantized_distillation_tpu.train import tasks, trainer

    batches = [_nmt_batch(10 + i) for i in range(STEPS)]
    args = [jnp.asarray(batches[0][k]) for k in ("src", "src_len", "tgt_in")]
    js = jmake_seq2seq("student_small", V, V, hidden=48, embed_dim=24, num_layers=2, dropout=0.0)
    jt = jmake_seq2seq("student_small", V, V, hidden=40, embed_dim=16, num_layers=2, dropout=0.0)
    sv = jax.tree.map(np.asarray, js.init(jax.random.PRNGKey(1), *args))
    tv = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(2), *args))
    payload = {"student_cfg": dataclasses.asdict(js.cfg), "student": sv["params"],
               "teacher_cfg": dataclasses.asdict(jt.cfg), "teacher": tv["params"],
               "batches": batches}
    names = [n for n, _ in _models(payload)[0].named_parameters()]
    out = {}
    for mode in ("weights", "joint"):
        quant = JQuant(bits=4) if mode == "weights" else JQuant(bits=2, method="codebook")
        jtx = trainer.build_optimizer(JTrainConfig(**ADAM))
        state = trainer.create_train_state(sv["params"], jtx, quant=quant, mode=mode)
        step = trainer.make_train_step(tasks.nmt_task(js, jt, tv), jtx, quant=quant,
                                       distill=JDistill(*DISTILL), mode=mode, donate=False)
        metrics = []
        for batch in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
        flat = flatten_tree(params_from_numpy(jax.tree.map(np.asarray, state.params)))
        out[mode] = {"metrics": metrics,
                     "params": {n: t.numpy() for n, t in fuse_flax_leaves(flat, names).items()},
                     "codebooks": None if state.codebooks is None else
                     {p: np.asarray(b) for p, b in state.codebooks.items()}}
    return types.SimpleNamespace(payload=payload, out=out)


@pytest.fixture(scope="module")
def refs(jx):
    return {leg: _reference(jx.payload, leg) for leg in LEGS}


@pytest.fixture(scope="module")
def ranks(jx, refs, tmp_path_factory):
    payload = dict(jx.payload, refs=refs, jax=jx.out)
    return run_ranks(_rank, 2, args=(payload,), timeout=120, join_timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("mesh_graph")))


def _close(got, want, what):
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=W_RTOL, atol=W_ATOL,
                                   err_msg=f"{what} {n}")


def _check_metrics(got, want, scale_sums=1):
    """Every step's metrics: ``scale_sums`` times the port's ``nll_sum`` and
    ``n_tokens`` against ``want``'s."""
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        for k in w:
            s = scale_sums if k in SUM_METRICS else 1
            np.testing.assert_allclose(g[k] * s, w[k], rtol=LOSS_RTOL, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("leg", list(LEGS))
def test_mesh_steps_equal_the_one_process_steps(ranks, refs, leg):
    ref = refs[leg]
    for r, out in enumerate(ranks):
        got = out[leg]
        _check_metrics(got["metrics"], ref["metrics"])
        _close(got["params"], got["ref_params"], f"{leg} rank {r}")
        if ref["codebooks"] is not None:  # whole on every rank
            _close(got["codebooks"], ref["codebooks"], f"{leg} rank {r} codebook")
    # the learning rate and the bias corrections moved every step
    assert len({round(m["loss"], 9) for m in ref["metrics"]}) == STEPS


@pytest.mark.parametrize("leg", JAX_LEGS)
def test_f32_mesh_steps_match_jax(ranks, jx, leg):
    spec = LEGS[leg]
    want = jx.out[spec["mode"]]
    for r, out in enumerate(ranks):
        got = out[leg]
        _check_metrics(got["metrics"], want["metrics"], scale_sums=spec["mesh"][0])
        _close(got["params"], got["jax_params"], f"{leg} rank {r} vs JAX")
        if want["codebooks"] is not None:
            _close(got["codebooks"], want["codebooks"], f"{leg} rank {r} codebook vs JAX")


@pytest.mark.parametrize("leg", ["dp_f32", "dp_bf16"])
def test_data_parallel_ranks_hold_the_same_weights(ranks, leg):
    a, b = (out[leg]["params"] for out in ranks)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_bf16_reduce_halves_the_gradient_bytes(ranks):
    for out in ranks:
        def data_bytes(leg):
            return [sum(b for _, b, axis, _ in ops if axis == DATA_AXIS)
                    for ops in out[leg]["budgets"]]

        full, half = data_bytes("dp_f32"), data_bytes("dp_bf16")
        assert all(h < 0.51 * f for h, f in zip(half, full)), (half, full)


@pytest.mark.parametrize("leg", list(LEGS))
def test_every_step_issues_the_same_collectives(ranks, leg):
    """What a replayed graph records again: one step's collectives are the
    next one's."""
    for out in ranks:
        budgets = out[leg]["budgets"]
        assert budgets[0] and all(b == budgets[0] for b in budgets)
        kinds = {kind + "@" + axis for kind, _, axis, _ in budgets[0]}
        want = ({"all-gather@model", "reduce-scatter@model", "all-reduce@model"}
                if LEGS[leg].get("tp") else {"all-reduce@data"})
        assert want <= kinds, kinds


@pytest.mark.parametrize("leg", list(LEGS))
def test_gloo_mesh_steps_run_eagerly(ranks, leg):
    for out in ranks:
        got = out[leg]
        assert got["graphed"] is False and got["captures"] == 0
        assert got["capturable"] == [False, False]  # the CPU; gloo, even for a CUDA device


# ------------------------------------------------------------- on the card


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    """Mesh (1, 1) of an NCCL group of world size 1 (a file store)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.cuda.set_device(0)  # the communicators' device, before the mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=timedelta(seconds=120))
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _card_leg(leg, mesh):
    """(task, tx, quant, mode, state, step keywords, batches) of a leg on
    the card at mesh (1, 1)."""
    dev = torch.device("cuda")
    tx = build_optimizer(TrainConfig(**ADAM))
    if leg == "lm_tp_carry":
        student = make_lm("student_small", V, embed_dim=24, hidden=24, num_layers=2,
                          dropout=0.3, device=dev, seed=6)
        teacher = make_lm("student_small", V, embed_dim=16, hidden=32, num_layers=2,
                          dropout=0.0, device=dev, seed=7)
        task = lm_task(student, teacher, thread_carry=True, device=dev)
        quant, mode = QuantSpec(bits=4), "weights"
        rng = np.random.default_rng(8)
        stream = rng.integers(0, V, (B, STEPS * 5 + 1)).astype(np.int32)
        batches = [{"input": stream[:, i * 5:(i + 1) * 5],
                    "target": stream[:, i * 5 + 1:(i + 1) * 5 + 1]} for i in range(STEPS)]
        carry = lm_initial_carry(student, B, teacher)
        tp = True
    else:
        student = make_seq2seq("student_small", V, V, hidden=48, embed_dim=24, num_layers=2,
                               dropout=0.3, device=dev, seed=1)
        teacher = make_seq2seq("student_small", V, V, hidden=40, embed_dim=16, num_layers=2,
                               dropout=0.0, device=dev, seed=2)
        task = nmt_task(student, teacher, device=dev)
        mode = "joint" if leg == "tp_joint" else "weights"
        quant = _quant(mode)
        batches = [_nmt_batch(50 + i) for i in range(STEPS)]
        carry, tp = None, leg.startswith("tp")
    whole = dict(student.named_parameters())
    specs = placed_pspecs(whole, mesh) if tp else None
    params = place_params_seq2seq(whole, mesh, device=dev) if tp else whole
    state = create_train_state(params, tx, quant=quant, mode=mode, carry=carry, mesh=mesh,
                               param_specs=specs, device=dev)
    kw = dict(quant=quant, distill=DistillSpec(*DISTILL), mode=mode, mesh=mesh,
              param_specs=specs, device=dev,
              grad_reduce_dtype=torch.bfloat16 if leg == "dp_bf16" else None)
    return task, tx, state, kw, batches


def _budget(ops):
    return [(op.kind, op.bytes, op.axis, op.group_size) for op in ops]


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["dp_bf16", "tp_weights", "tp_joint", "lm_tp_carry"])
def test_gpu_graphed_mesh_steps_equal_eager_steps(nccl, leg):
    """Four steps graphed and four eager from copies of one state: every
    tensor of the state (the carry too), every loss and every step's
    collectives equal; one capture; one fake-quant launch a STE step."""
    task, tx, state, kw, batches = _card_leg(leg, nccl)
    runs = {}
    for eager in (True, False):
        st = _clone_state(state)
        step = make_train_step(task, tx, _eager=eager, **kw)
        assert step.graphed is not eager
        n0, losses, budgets = fake_quant_buckets.launches, [], []
        for batch in batches:
            with collective_budget(nccl) as budget:
                st, m = step(st, place_batch(batch, nccl, device="cuda"), 3)
                losses.append(float(m["loss"]))
            budgets.append(_budget(budget.ops))
        runs[eager] = (st, losses, budgets, fake_quant_buckets.launches - n0, step.captures)
    (eager, e_loss, e_bud, e_fq, e_cap), (graph, g_loss, g_bud, g_fq, g_cap) = (
        runs[True], runs[False])
    assert e_cap == 0 and g_cap == 1
    assert e_fq == g_fq == (0 if leg == "tp_joint" else STEPS)
    assert e_loss == g_loss
    assert e_bud[0] and g_bud == e_bud  # the capture's records, made again at each replay
    for a, b in zip(_leaves([eager.params, eager.opt_state.mu, eager.opt_state.nu,
                             eager.codebooks, eager.carry]),
                    _leaves([graph.params, graph.opt_state.mu, graph.opt_state.nu,
                             graph.codebooks, graph.carry]), strict=True):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_one_capture_per_signature_on_a_mesh(nccl):
    task, tx, state, kw, batches = _card_leg("tp_weights", nccl)
    step = make_train_step(task, tx, **kw)
    for batch in batches[:3]:
        state, _ = step(state, place_batch(batch, nccl, device="cuda"), 0)
    assert step.captures == 1
    state, _ = step(state, _nmt_batch(63, b=2), 0)  # a batch of a new shape
    assert step.captures == 2
    other = _clone_state(state)  # a new state: other tensors
    other, _ = step(other, batches[0], 0)
    assert step.captures == 3
    state, _ = step(state, batches[1], 0)  # the first signature again
    assert step.captures == 3
