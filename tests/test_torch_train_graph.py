"""The PyTorch port's train step in its replayable form (``prepare`` on the
host, ``body`` on the device; one CUDA graph per signature on the card)
against the JAX package's ``make_train_step(..., donate=False)``.

Four Adam steps with global-norm clipping and a learning rate halved every
step (``exponential_decay_staircase(every=1, rate=0.5)``), so a learning
rate or a bias correction frozen at its first value shows by step 2.
Tolerances as ``tests/test_torch_train.py`` states them for whole steps
(f32 on the CPU, summation order differs between XLA and PyTorch): losses
and metrics rtol 1e-5; parameters, codebooks, running statistics and carry
rtol 1e-5, atol 1e-6.

The clip norm (1e-5) clips every step, so the gradients Adam normalizes
are at most about its eps (1e-8), where ``g / (sqrt(v) + eps)`` is smooth
in ``g``: a gradient difference at the level of rounding stays at that
level in the step. At a larger scale a gradient that is rounding noise
(a true zero) is normalized to a step of about ``±lr`` whose sign is the
noise's, which no rounding tolerance holds (``tests/test_torch_train.py``
holds Adam to optax on equal gradients for that reason); a learning rate
or a bias correction frozen at step 1 still moves every step by its whole
size here.

Tests marked ``gpu`` hold the graphed step to the eager one on the card
and count its captures; they skip where PyTorch sees no card. JAX is
imported inside the CPU tests' fixtures, so ``pytest -m gpu`` runs
without JAX.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.convert import (
    batch_stats_to_numpy,
    flatten_tree,
    params_from_numpy,
    params_to_numpy,
)
from quantized_distillation_tpu_torch.kernels import fake_quant_buckets
from quantized_distillation_tpu_torch.models import (
    CNNSpec,
    ConvForwardNet,
    Seq2Seq,
    Seq2SeqConfig,
    WideResNet,
    make_lm,
    make_seq2seq,
)
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    lm_initial_carry,
    lm_task,
    make_eval_step,
    make_train_step,
    nmt_task,
    vision_task,
)
from quantized_distillation_tpu_torch.train.trainer import _clone_state, _leaves

torch.set_num_threads(2)

V, STEPS = 40, 4
LOSS_RTOL = 1e-5
W_RTOL, W_ATOL = 1e-5, 1e-6
# Adam, clipped, the learning rate halved every step
ADAM = dict(optimizer="adam", learning_rate=1e-3, clip_norm=1e-5, lr_schedule="step",
            lr_decay_every=1, lr_decay_rate=0.5)
DISTILL = (0.5, 2.0)


def _tensors(state):
    """Every tensor of a train state."""
    opt = state.opt_state
    return _leaves([state.params, opt.mu, opt.nu, state.batch_stats, state.codebooks,
                    state.carry])


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=W_RTOL, atol=W_ATOL,
                               err_msg=err_msg)


def _nmt_batch(seed, b=3, ts=5, tt=4):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, tt), np.float32)
    mask[1, -1] = 0.0
    return {
        "src": rng.integers(4, V, (b, ts)).astype(np.int32),
        "src_len": np.array([ts, ts - 2, 1][:b], np.int32),
        "tgt_in": rng.integers(1, V, (b, tt)).astype(np.int32),
        "tgt_out": rng.integers(1, V, (b, tt)).astype(np.int32),
        "tgt_mask": mask,
    }


def _lm_windows(seed, n, b=3, t=5):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, V, (b, n * t + 1)).astype(np.int32)
    return [{"input": stream[:, i * t:(i + 1) * t], "target": stream[:, i * t + 1:(i + 1) * t + 1]}
            for i in range(n)]


def _images(seed, b=4, size=8):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((b, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, 10, (b,)).astype(np.int32)}


def _normal_leaves(jx, shapes, seed, vision=False):
    """A flax variables tree of the given shapes, made from a seed: kernels
    N(0, 1/fan_in), embeddings N(0, 1/embed_dim), biases and means N(0,
    0.1^2), BatchNorm scales 1 + N(0, 0.1^2), variances 1 + |N(0, 0.1^2)|."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        z = rng.standard_normal(shape.shape)
        name = path[-1].key
        if name == "kernel":
            z = z / np.sqrt(np.prod(shape.shape[:-1]))
        elif name == "embedding":
            z = z / np.sqrt(shape.shape[1])
        elif vision and name in ("scale", "var"):
            z = 1 + 0.1 * (np.abs(z) if name == "var" else z)
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jx.jax.tree_util.tree_map_with_path(leaf, dict(shapes))


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import DistillSpec as JDistill
    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.config import TrainConfig as JTrainConfig
    from quantized_distillation_tpu.models import cnn, make_lm as jmake_lm
    from quantized_distillation_tpu.models import make_seq2seq as jmake_seq2seq
    from quantized_distillation_tpu.models import wide_resnet
    from quantized_distillation_tpu.train import tasks, trainer

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Quant=JQuant, Distill=JDistill, TrainConfig=JTrainConfig,
        make_seq2seq=jmake_seq2seq, make_lm=jmake_lm, cnn=cnn, wrn=wide_resnet, tasks=tasks,
        trainer=trainer)


def _jax_steps(jx, task, variables, batches, quant, mode="weights", carry=None):
    """The JAX package's step over ``batches`` from ``variables`` → (state,
    metrics of each step)."""
    jtx = jx.trainer.build_optimizer(jx.TrainConfig(**ADAM))
    state = jx.trainer.create_train_state(
        variables["params"], jtx, batch_stats=variables.get("batch_stats"), quant=quant,
        mode=mode, carry=carry)
    step = jx.trainer.make_train_step(task, jtx, quant=quant, distill=jx.Distill(*DISTILL),
                                      mode=mode, donate=False)
    metrics = []
    for batch in batches:
        state, m = step(state, {k: jx.jnp.asarray(v) for k, v in batch.items()},
                        jx.jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_steps(task, state, batches, quant, mode="weights", donate=True):
    """The port's step over ``batches``, each through its ``prepare`` and
    ``body`` → (step, state, metrics of each step)."""
    step = make_train_step(task, build_optimizer(TrainConfig(**ADAM)), quant=quant,
                           distill=DistillSpec(*DISTILL), mode=mode, donate=donate,
                           device="cpu")
    metrics = []
    for batch in batches:
        run = step.prepare(state, batch, 0)
        step.body(run)
        state, m = step.finish(state, run)
        metrics.append({k: float(v) for k, v in m.items()})
    return step, state, metrics


def _check_metrics(got, want):
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"step {i} {k}")


def _check_tree(got, want):
    want = flatten_tree(jax_numpy(want))
    got = flatten_tree(got)
    assert got.keys() == want.keys()
    for path, w in want.items():
        _close(got[path], w, path)


def jax_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- seq2seq


@pytest.fixture(scope="module")
def nmt(jx):
    b = _nmt_batch(0)
    args = [jx.jnp.asarray(b[k]) for k in ("src", "src_len", "tgt_in")]
    js = jx.make_seq2seq("student_small", V, V, hidden=48, embed_dim=24, num_layers=2,
                         dropout=0.0)
    jt = jx.make_seq2seq("student_small", V, V, hidden=40, embed_dim=16, num_layers=2,
                         dropout=0.0)
    sv = js.init(jx.jax.random.PRNGKey(1), *args)
    tv = jx.jax.tree.map(np.asarray, jt.init(jx.jax.random.PRNGKey(2), *args))

    def port(jm, v):
        return Seq2Seq(Seq2SeqConfig(**dataclasses.asdict(jm.cfg)), device="cpu").load_params(
            params_from_numpy(jx.jax.tree.map(np.asarray, v["params"])))

    return types.SimpleNamespace(js=js, jt=jt, sv=sv, tv=tv, port=lambda: port(js, sv),
                                 teacher=port(jt, tv))


@pytest.mark.parametrize("mode", ["weights", "joint"])
def test_seq2seq_adam_steps_match_jax(jx, nmt, mode):
    batches = [_nmt_batch(10 + i) for i in range(STEPS)]
    method = "uniform" if mode == "weights" else "codebook"
    jstate, jm = _jax_steps(jx, jx.tasks.nmt_task(nmt.js, nmt.jt, nmt.tv), nmt.sv, batches,
                            jx.Quant(bits=4, method=method), mode)
    student = nmt.port()
    quant = QuantSpec(bits=4, method=method)
    state = create_train_state(dict(student.named_parameters()),
                               build_optimizer(TrainConfig(**ADAM)), quant=quant, mode=mode,
                               device="cpu")
    _, state, m = _port_steps(nmt_task(student, nmt.teacher, device="cpu"), state, batches,
                              quant, mode)
    _check_metrics(m, jm)
    assert state.step == jstate.step == STEPS and state.opt_state.count == STEPS
    _check_tree(params_to_numpy(state.params), jstate.params)
    if mode == "joint":
        assert state.codebooks.keys() == jstate.codebooks.keys()
        for path, w in jstate.codebooks.items():
            _close(state.codebooks[path].detach(), w, path)


def test_donate_false_leaves_the_inputs_and_matches_donate_true(nmt):
    batches = [_nmt_batch(20 + i) for i in range(STEPS)]
    quant = QuantSpec(bits=4, method="codebook")
    task = nmt_task(nmt.port(), nmt.teacher, device="cpu")
    runs = {}
    for donate in (True, False):
        student = nmt.port()
        state = create_train_state(dict(student.named_parameters()),
                                   build_optimizer(TrainConfig(**ADAM)), quant=quant,
                                   mode="joint", device="cpu")
        before = [t.detach().clone() for t in _tensors(state)]
        inputs = _tensors(state)
        _, new, m = _port_steps(task, state, batches, quant, "joint", donate=donate)
        runs[donate] = (new, m)
        after = _tensors(state)
        if donate:  # stepped in place: the model's own weights moved
            assert any(not torch.equal(a, b) for a, b in zip(after, before, strict=True))
            assert all(a is b for a, b in zip(_tensors(new), inputs, strict=True))
        else:  # untouched, and the new state holds none of the caller's tensors
            assert all(torch.equal(a, b) for a, b in zip(after, before, strict=True))
            assert state.step == 0 and state.opt_state.count == 0
            ptrs = {t.data_ptr() for t in inputs}
            assert not any(t.data_ptr() in ptrs for t in _tensors(new))
            assert all(p.requires_grad == q.requires_grad
                       for p, q in zip(_leaves(new.params), _leaves(state.params)))
    (new_t, m_t), (new_f, m_f) = runs[True], runs[False]
    assert m_t == m_f and new_t.step == new_f.step and \
        new_t.opt_state.count == new_f.opt_state.count
    for a, b in zip(_tensors(new_t), _tensors(new_f), strict=True):
        assert torch.equal(a, b)


def test_step_call_is_prepare_then_body_and_metrics_are_new_tensors(nmt):
    batches = [_nmt_batch(30 + i) for i in range(2)]
    quant = QuantSpec(bits=4)
    task = nmt_task(nmt.port(), nmt.teacher, device="cpu")
    states = [create_train_state(dict(nmt.port().named_parameters()),
                                 build_optimizer(TrainConfig(**ADAM)), quant=quant, device="cpu")
              for _ in range(2)]
    _, by_parts, m_parts = _port_steps(task, states[0], batches, quant)
    step = make_train_step(task, build_optimizer(TrainConfig(**ADAM)), quant=quant,
                           distill=DistillSpec(*DISTILL), device="cpu")
    state, first = step(states[1], batches[0], 0)
    kept = {k: v.clone() for k, v in first.items()}
    state, second = step(state, batches[1], 0)
    # the next step wrote its metrics elsewhere: the first ones stand
    assert all(torch.equal(first[k], kept[k]) for k in kept)
    assert not torch.equal(first["loss"], second["loss"])
    assert [{k: float(v) for k, v in m.items()} for m in (first, second)] == m_parts
    for a, b in zip(_leaves(state.params), _leaves(by_parts.params), strict=True):
        assert torch.equal(a, b)
    assert step.captures == 0  # the CPU never captures


# --------------------------------------------------------------------- LM


@pytest.fixture(scope="module")
def lm(jx):
    def twin(seed, **kw):
        jm = jx.make_lm("student_small", V, **kw)
        shapes = jx.jax.eval_shape(jm.init, jx.jax.random.PRNGKey(0),
                                   jx.jnp.zeros((1, 5), int))
        params = _normal_leaves(jx, shapes["params"], seed)
        return jm, {"params": params}, lambda: make_lm("student_small", V, device="cpu",
                                                       **kw).load_params(params)

    js, sv, port = twin(6, embed_dim=24, hidden=24, num_layers=2, dropout=0.0)
    jt, tv, tport = twin(7, embed_dim=16, hidden=32, num_layers=2, dropout=0.0)
    return types.SimpleNamespace(js=js, sv=sv, port=port, jt=jt, tv=tv, teacher=tport())


def test_lm_adam_steps_thread_the_carry_as_jax(jx, lm):
    windows = _lm_windows(8, STEPS)
    jcarry = jx.tasks.lm_initial_carry(lm.js, 3, lm.jt)
    jstate, jm = _jax_steps(jx, jx.tasks.lm_task(lm.js, lm.jt, lm.tv, thread_carry=True),
                            lm.sv, windows, jx.Quant(bits=4), carry=jcarry)
    student = lm.port()
    carry = lm_initial_carry(student, 3, lm.teacher)
    state = create_train_state(dict(student.named_parameters()),
                               build_optimizer(TrainConfig(**ADAM)), quant=QuantSpec(bits=4),
                               carry=carry, device="cpu")
    task = lm_task(student, lm.teacher, thread_carry=True, device="cpu")
    _, state, m = _port_steps(task, state, windows, QuantSpec(bits=4))
    _check_metrics(m, jm)
    _check_tree(params_to_numpy(state.params), jstate.params)
    for who in ("student", "teacher"):
        for (c, h), (jc, jh) in zip(state.carry[who], jstate.carry[who], strict=True):
            _close(c, jc, f"{who} c")
            _close(h, jh, f"{who} h")
    assert all(not t.any() for t in _leaves(carry))  # the caller's carry was copied


def test_returned_carry_is_not_overwritten_by_the_next_step(lm):
    student = lm.port()
    step = make_train_step(lm_task(student, lm.teacher, thread_carry=True, device="cpu"),
                           build_optimizer(TrainConfig(**ADAM)), quant=QuantSpec(bits=4),
                           distill=DistillSpec(*DISTILL), device="cpu")
    state = create_train_state(dict(student.named_parameters()),
                               build_optimizer(TrainConfig(**ADAM)), quant=QuantSpec(bits=4),
                               carry=lm_initial_carry(student, 3, lm.teacher), device="cpu")
    outs = []
    for window in _lm_windows(9, 3):
        state, m = step(state, window, 0)
        outs.append((state.carry, m, [t.clone() for t in _leaves(state.carry)]))
    for carry, m, kept in outs:
        assert all(torch.equal(a, b) for a, b in zip(_leaves(carry), kept, strict=True))
        assert all(t.grad_fn is None and not t.requires_grad for t in _leaves(carry))
    assert not torch.equal(_leaves(outs[0][0])[1], _leaves(outs[1][0])[1])
    assert len({id(t) for c, _, _ in outs for t in _leaves(c)}) == 3 * len(outs[0][2])


# ------------------------------------------------------------------ vision


def test_batchnorm_student_adam_steps_match_jax(jx):
    jm = jx.wrn.WideResNet(depth=10, widen=1, num_classes=10)
    jt = jx.cnn.ConvForwardNet(jx.cnn.CNNSpec(conv=((16, True), (8, False)), fc=(32,),
                                              num_classes=10, dropout=0.0))
    x0 = jx.jnp.zeros((1, 8, 8, 3))
    jv = _normal_leaves(jx, jx.jax.eval_shape(jm.init, jx.jax.random.PRNGKey(0), x0), 0,
                        vision=True)
    tv = _normal_leaves(jx, jx.jax.eval_shape(jt.init, jx.jax.random.PRNGKey(0), x0), 5,
                        vision=True)
    batches = [_images(40 + i) for i in range(STEPS)]
    jstate, jmetrics = _jax_steps(jx, jx.tasks.vision_task(jm, jt, tv), jv, batches,
                                  jx.Quant(bits=4))
    student = WideResNet(depth=10, widen=1, num_classes=10, device="cpu")
    student.load_params(jv["params"]).load_batch_stats(jv["batch_stats"])
    teacher = ConvForwardNet(CNNSpec(conv=((16, True), (8, False)), fc=(32,), num_classes=10,
                                     dropout=0.0), image_size=8, device="cpu")
    teacher.load_params(tv["params"]).load_batch_stats(tv["batch_stats"])
    state = create_train_state(dict(student.named_parameters()),
                               build_optimizer(TrainConfig(**ADAM)),
                               batch_stats=dict(student.named_buffers()), quant=QuantSpec(bits=4),
                               device="cpu")
    _, state, m = _port_steps(vision_task(student, teacher, device="cpu"), state, batches,
                              QuantSpec(bits=4))
    _check_metrics(m, jmetrics)
    _check_tree(params_to_numpy(state.params), jstate.params)
    _check_tree(batch_stats_to_numpy(state.batch_stats), jstate.batch_stats)
    # in place: the model's own statistics are the state's
    assert all(state.batch_stats[n] is t for n, t in student.named_buffers())


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_setup(dropout=0.3, mode="weights", stochastic=False):
    student = make_seq2seq("student_small", V, V, hidden=48, embed_dim=24, num_layers=2,
                           dropout=dropout, device="cuda", seed=1)
    teacher = make_seq2seq("student_small", V, V, hidden=40, embed_dim=16, num_layers=2,
                           dropout=0.0, device="cuda", seed=2)
    method = "uniform" if mode == "weights" else "codebook"
    quant = QuantSpec(bits=4, method=method, stochastic=stochastic)
    tx = build_optimizer(TrainConfig(**ADAM))
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant, mode=mode,
                               device="cuda")
    return nmt_task(student, teacher, device="cuda"), tx, quant, state


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["weights", "joint", "stochastic"])
def test_gpu_graphed_steps_equal_eager_steps(cuda, mode):
    """Dropout on (rate 0.3), and stochastic rounding in mode
    ``stochastic``: the masks, the rounding draws, the losses and every
    tensor of the state equal the eager step's bit for bit after 4 steps;
    one fake-quant launch a deterministic STE step, none in codebook
    training or with stochastic rounding (the plain path)."""
    stochastic = mode == "stochastic"
    mode = "weights" if stochastic else mode
    task, tx, quant, state = _card_setup(mode=mode, stochastic=stochastic)
    batches = [_nmt_batch(50 + i) for i in range(STEPS)]
    runs = {}
    for eager in (True, False):
        st = _clone_state(state)
        step = make_train_step(task, tx, quant=quant, distill=DistillSpec(*DISTILL), mode=mode,
                               device="cuda", _eager=eager)
        n0, losses = fake_quant_buckets.launches, []
        for batch in batches:
            st, m = step(st, batch, 3)
            losses.append(float(m["loss"]))
        runs[eager] = (st, losses, fake_quant_buckets.launches - n0, step.captures)
    (eager, e_loss, e_fq, e_cap), (graph, g_loss, g_fq, g_cap) = runs[True], runs[False]
    assert e_cap == 0 and g_cap == 1
    assert e_fq == g_fq == (STEPS if mode == "weights" and not stochastic else 0)
    assert e_loss == g_loss
    for a, b in zip(_tensors(eager), _tensors(graph), strict=True):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_one_capture_per_signature(cuda):
    task, tx, quant, state = _card_setup()
    step = make_train_step(task, tx, quant=quant, distill=DistillSpec(*DISTILL), device="cuda")
    for i in range(3):
        state, _ = step(state, _nmt_batch(60 + i), 0)
    assert step.captures == 1
    state, _ = step(state, _nmt_batch(63, b=2), 0)  # a batch of a new shape
    assert step.captures == 2
    other = _clone_state(state)  # a new state: other tensors
    other, _ = step(other, _nmt_batch(64), 0)
    assert step.captures == 3
    state, _ = step(state, _nmt_batch(65), 0)  # the first signature again
    assert step.captures == 3
    ev = make_eval_step(task, quant=quant, device="cuda")
    n0 = fake_quant_buckets.launches
    got = [ev(state, _nmt_batch(66)) for _ in range(2)]
    want = make_eval_step(task, quant=quant, device="cuda", _eager=True)(state, _nmt_batch(66))
    assert fake_quant_buckets.launches - n0 == 3
    for m in got:
        assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in want.items()}


def test_grid_spread_alternates_graphed_and_eager_runs(capsys):
    """``scripts.grid_spread`` at a tiny size on the CPU, where every step
    is eager and deterministic: the runs alternate kinds, fit's step is
    graphed again after an eager run, and the runs agree."""
    from quantized_distillation_tpu_torch.scripts import grid_spread
    from quantized_distillation_tpu_torch.train import loops

    graphed = loops.make_train_step
    assert grid_spread.main(["--runs", "3", "--device", "cpu", "--cnn-teacher", "student_small",
                             "--cnn-data", "64", "--epochs", "1", "--teacher-epochs", "1",
                             "--batch", "32"]) == 0
    assert loops.make_train_step is graphed
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"run"')]
    assert [r["kind"] for r in lines] == ["graph", "eager", "eager"]
    assert lines[0]["cells"] == lines[1]["cells"] == lines[2]["cells"]
    assert len(lines[0]["cells"]) == 8 and set(lines[0]["contract_checks"]) == {
        "cnn_4bit_within_2pts_of_fp", "cnn_2bit_degrades_narrow", "cnn_widening_recovers_2bit"}
