"""The PyTorch port's LSTM language model and ``lm_task`` against the JAX
package's, on the same weights and inputs (numpy, from seeds), at small
widths: the forward with and without a carry, untied and tied; two 4-bit
STE KD steps with and without carry threading; ``evaluate(initial_carry=)``
and ``fit(carry_reset=)`` over two tiny epochs.

Tolerances (f32 on the CPU, summation order differs between XLA and
PyTorch): logits and carries rtol = atol = 1e-5; losses and metrics rtol
1e-5; SGD-updated parameters and carries rtol 1e-5, atol 1e-6.

Tests marked ``gpu`` run threaded steps on the card against the CPU; they
skip where PyTorch sees no card. JAX is imported inside the CPU tests'
fixtures, so ``pytest -m gpu`` runs without JAX.
"""

import json
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.convert import flatten_tree, params_to_numpy
from quantized_distillation_tpu_torch.kernels import fake_quant_buckets
from quantized_distillation_tpu_torch.models import LMConfig, LSTMLanguageModel, make_lm
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    evaluate,
    fit,
    lm_initial_carry,
    lm_task,
    make_eval_step,
    make_train_step,
)
from quantized_distillation_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(2)

V, B, T = 50, 3, 5
RTOL = ATOL = 1e-5
LOSS_RTOL = 1e-5
W_RTOL, W_ATOL = 1e-5, 1e-6
SGD = dict(learning_rate=0.5, clip_norm=0.05, optimizer="sgd")
STUDENT = dict(embed_dim=24, hidden=24, num_layers=2, dropout=0.0)
TEACHER = dict(embed_dim=16, hidden=32, num_layers=2, dropout=0.0)


def _windows(seed, n=1, b=B):
    """``n`` contiguous-BPTT windows of one token stream per row."""
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, V, (b, n * T + 1)).astype(np.int32)
    return [{"input": stream[:, i * T:(i + 1) * T], "target": stream[:, i * T + 1:(i + 1) * T + 1]}
            for i in range(n)]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import DistillSpec as JDistill
    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.config import TrainConfig as JTrainConfig
    from quantized_distillation_tpu.models import make_lm as jmake
    from quantized_distillation_tpu.train import loops, tasks, trainer
    from quantized_distillation_tpu.utils.metrics import MetricsLogger as JLogger

    return types.SimpleNamespace(jax=jax, jnp=jnp, Quant=JQuant, Distill=JDistill,
                                 TrainConfig=JTrainConfig, make=jmake, trainer=trainer,
                                 tasks=tasks, loops=loops, Logger=JLogger)


def _twin(jx, seed, **kw):
    """(flax LM, its params, the port LM holding the same). Values: kernels
    N(0, 1/fan_in), embeddings N(0, 1/embed_dim), biases N(0, 0.1^2), in the
    tree ``init`` gives (shapes from ``jax.eval_shape``)."""
    jm = jx.make("student_small", V, **kw)
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        z = rng.standard_normal(shape.shape)
        name = path[-1].key
        if name == "kernel":
            z = z / np.sqrt(shape.shape[0])
        elif name == "embedding":
            z = z / np.sqrt(shape.shape[1])
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    shapes = jx.jax.eval_shape(jm.init, jx.jax.random.PRNGKey(0), jx.jnp.zeros((1, T), int))
    params = jx.jax.tree_util.tree_map_with_path(leaf, dict(shapes["params"]))
    port = make_lm("student_small", V, device="cpu", **kw).load_params(params)
    return jm, {"params": params}, port


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _close_carry(got, want, **kw):
    for (c, h), (jc, jh) in zip(got, want, strict=True):
        _close(c.detach(), jc, "c", **kw)
        _close(h.detach(), jh, "h", **kw)


def _carry(seed, hidden=24, layers=2):
    rng = np.random.default_rng(seed)
    return tuple(tuple(rng.standard_normal((B, hidden)).astype(np.float32) for _ in range(2))
                 for _ in range(layers))


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_forward_matches_jax(jx, tied, with_carry):
    jm, jv, port = _twin(jx, 1, tie_embeddings=tied, **STUDENT)
    tokens = _windows(2)[0]["input"]
    carry = _carry(3) if with_carry else None
    want, wcarry = jx.jax.jit(jm.apply)(jv, jx.jnp.asarray(tokens), carry)
    tcarry = None if carry is None else tuple(tuple(map(torch.from_numpy, s)) for s in carry)
    got, gcarry = port(torch.from_numpy(tokens).long(), tcarry)
    _close(got, want, "logits")
    _close_carry(gcarry, wcarry)
    # the same through forward_with, on substituted weights
    got2, _ = port.forward_with(dict(port.named_parameters()), torch.from_numpy(tokens).long(),
                                tcarry)
    assert torch.equal(got, got2)
    names = {n for n, _ in port.named_parameters()}
    assert ("generator.kernel" in names) == (not tied)


def test_round_trip_and_initial_carry(jx):
    for tied in (False, True):
        _, jv, port = _twin(jx, 4, tie_embeddings=tied, **STUDENT)
        got, want = flatten_tree(params_to_numpy(port)), flatten_tree(jv["params"])
        assert got.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=path)
    carry = port.initial_carry(B)
    assert len(carry) == 2 and all(t.shape == (B, 24) and not t.any() for s in carry for t in s)
    assert len({t.data_ptr() for s in carry for t in s}) == 4  # each its own buffer
    with pytest.raises(ValueError, match="tie_embeddings"):
        LSTMLanguageModel(LMConfig(vocab=V, embed_dim=8, hidden=16, tie_embeddings=True),
                          device="cpu")


def test_train_mode_dropout_is_seeded_and_eval_is_dropout_free():
    m = make_lm("student_small", V, device="cpu", embed_dim=24, hidden=24, num_layers=2,
                dropout=0.5, seed=1)
    x = torch.from_numpy(_windows(5)[0]["input"]).long()
    a1, _ = m(x, train=True, generator=torch.Generator().manual_seed(3))
    a2, _ = m(x, train=True, generator=torch.Generator().manual_seed(3))
    a3, _ = m(x, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a1, a2) and not torch.allclose(a1, a3)
    assert torch.equal(m(x)[0], m(x)[0])
    with pytest.raises(ValueError, match="Generator"):
        m(x, train=True)


# ------------------------------------------------------------- train steps


def _jax_setup(jx, thread_carry):
    js, sv, student = _twin(jx, 6, **STUDENT)
    jt, tv, teacher = _twin(jx, 7, **TEACHER)
    jtask = jx.tasks.lm_task(js, jt, tv, thread_carry=thread_carry)
    task = lm_task(student, teacher, thread_carry=thread_carry, device="cpu")
    jcarry = jx.tasks.lm_initial_carry(js, B, jt) if thread_carry else None
    carry = lm_initial_carry(student, B, teacher) if thread_carry else None
    return types.SimpleNamespace(js=js, sv=sv, student=student, jt=jt, tv=tv, teacher=teacher,
                                 jtask=jtask, task=task, jcarry=jcarry, carry=carry)


def _jb(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("thread_carry", [False, True])
def test_two_ste_kd_steps_match_jax(jx, thread_carry):
    s = _jax_setup(jx, thread_carry)
    quant, jquant = QuantSpec(bits=4), jx.Quant(bits=4)
    jtx = jx.trainer.build_optimizer(jx.TrainConfig(**SGD))
    jstate = jx.trainer.create_train_state(s.sv["params"], jtx, quant=jquant, carry=s.jcarry)
    jstep = jx.trainer.make_train_step(s.jtask, jtx, quant=jquant, distill=jx.Distill(0.5, 2.0),
                                       donate=False)
    tx = build_optimizer(TrainConfig(**SGD))
    state = create_train_state(dict(s.student.named_parameters()), tx, quant=quant,
                               carry=s.carry, device="cpu")
    step = make_train_step(s.task, tx, quant=quant, distill=DistillSpec(0.5, 2.0), device="cpu")
    for batch in _windows(8, n=2):
        jstate, jm = jstep(jstate, _jb(jx, batch), jx.jax.random.PRNGKey(0))
        state, m = step(state, batch, 0)
        assert set(m) == set(jm) == {"loss", "grad_norm", "nll_sum", "n_tokens"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
        if thread_carry:
            _close_carry(state.carry["student"], jstate.carry["student"], rtol=W_RTOL,
                         atol=W_ATOL)
            _close_carry(state.carry["teacher"], jstate.carry["teacher"], rtol=W_RTOL,
                         atol=W_ATOL)
            assert all(t.grad_fn is None and not t.requires_grad
                       for who in ("student", "teacher") for s_ in state.carry[who] for t in s_)
        else:
            assert state.carry is None
    want = flatten_tree(jx.jax.tree.map(np.asarray, jstate.params))
    for path, w in flatten_tree(params_to_numpy(state.params)).items():
        _close(w, want[path], path, rtol=W_RTOL, atol=W_ATOL)
    # the caller's carry was copied, not consumed
    if thread_carry:
        assert all(not t.any() for s_ in s.carry["student"] for t in s_)


def test_threaded_carry_moves_and_the_next_step_reads_it(jx):
    s = _jax_setup(jx, True)
    seen = []

    def recording(params, batch, train, generator):
        seen.append(batch["carry"])
        return s.task.student_forward(params, batch, train, generator)

    task = type(s.task)(recording, s.task.loss_and_metrics, s.task.teacher_forward)
    tx = build_optimizer(TrainConfig(**SGD))
    state = create_train_state(dict(s.student.named_parameters()), tx, quant=QuantSpec(bits=4),
                               carry=s.carry, device="cpu")
    step = make_train_step(task, tx, quant=QuantSpec(bits=4), distill=DistillSpec(),
                           device="cpu")
    outs = []
    for batch in _windows(9, n=3):
        state, _ = step(state, batch, 0)
        outs.append(state.carry)
    for prev, nxt in zip(outs, seen[1:]):
        for who in ("student", "teacher"):
            for (c0, h0), (c1, h1) in zip(prev[who], nxt[who]):
                assert torch.equal(c0, c1) and torch.equal(h0, h1)
                assert c1.grad_fn is None and h1.grad_fn is None
    assert not torch.equal(outs[0]["student"][0][1], outs[1]["student"][0][1])


def test_evaluate_and_fit_thread_the_carry_as_jax(jx, tmp_path):
    s = _jax_setup(jx, True)
    quant, jquant = QuantSpec(bits=4), jx.Quant(bits=4)
    cfg = dict(epochs=2, log_every=0, eval_every=0, **SGD)
    train = _windows(10, n=2)
    valid = _windows(11, n=2)
    # evaluate from the initial carry, on the hard-quantized weights
    jeval = jx.trainer.make_eval_step(s.jtask, quant=jquant)
    ev = make_eval_step(s.task, quant=quant, device="cpu")
    jtx = jx.trainer.build_optimizer(jx.TrainConfig(**cfg))
    jstate = jx.trainer.create_train_state(s.sv["params"], jtx, quant=jquant, carry=s.jcarry)
    tx = build_optimizer(TrainConfig(**cfg))
    state = create_train_state(dict(s.student.named_parameters()), tx, quant=quant,
                               carry=s.carry, device="cpu")
    for init in (s.jcarry, None):
        want = jx.loops.evaluate(jeval, jstate, valid, initial_carry=init)
        got = evaluate(ev, state, valid, initial_carry=None if init is None else s.carry)
        assert set(got) == set(want) == {"perplexity"}
        np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=LOSS_RTOL)
    threaded = evaluate(ev, state, valid, initial_carry=s.carry)["perplexity"]
    assert threaded != evaluate(ev, state, valid)["perplexity"]
    # two epochs of two windows, a fresh carry each epoch, an eval after each
    jlog, log = tmp_path / "j.jsonl", tmp_path / "p.jsonl"
    jlogger, logger = jx.Logger(str(jlog), echo=False), MetricsLogger(str(log), echo=False)
    jstate = jx.loops.fit(s.jtask, jstate, jx.TrainConfig(quant=jquant,
                                                          distill=jx.Distill(0.5, 2.0), **cfg),
                          lambda epoch: iter(train), eval_batches=lambda: iter(valid), tx=jtx,
                          logger=jlogger, carry_reset=s.jcarry)
    state = fit(s.task, state, TrainConfig(quant=quant, distill=DistillSpec(0.5, 2.0), **cfg),
                lambda epoch: iter(train), eval_batches=lambda: iter(valid), tx=tx,
                logger=logger, carry_reset=s.carry, device="cpu")
    jlogger.close()
    logger.close()
    assert state.step == 4
    want = [json.loads(line) for line in jlog.read_text().splitlines()]
    got = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["event"] for r in got] == [r["event"] for r in want] == ["epoch", "epoch"]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g["loss"], g["perplexity"]], [w["loss"], w["perplexity"]],
                                   rtol=LOSS_RTOL)
    _close_carry(state.carry["student"], jstate.carry["student"], rtol=W_RTOL, atol=W_ATOL)
    want = flatten_tree(jx.jax.tree.map(np.asarray, jstate.params))
    for path, w in flatten_tree(params_to_numpy(state.params)).items():
        _close(w, want[path], path, rtol=W_RTOL, atol=W_ATOL)
    assert all(not t.any() for s_ in s.carry["student"] for t in s_)


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        make_lm("student_small", V)
    m = make_lm("student_small", V, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        lm_task(m)
    task = lm_task(m, thread_carry=True, device="cpu")
    tx = build_optimizer(TrainConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(dict(m.named_parameters()), tx, carry=lm_initial_carry(m, 2))
    state = create_train_state(dict(m.named_parameters()), tx, carry=lm_initial_carry(m, 2),
                               device="cpu")
    assert state.carry["teacher"] is None
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(task, tx)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_threaded_steps_launch_fake_quant_once_and_match_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for dev in ("cpu", "cuda"):
        student = make_lm("student_small", V, device=dev, seed=1, **STUDENT)
        teacher = make_lm("student_small", V, device=dev, seed=2, **TEACHER)
        tx = build_optimizer(TrainConfig(**SGD))
        state = create_train_state(dict(student.named_parameters()), tx, quant=QuantSpec(bits=4),
                                   carry=lm_initial_carry(student, B, teacher), device=dev)
        step = make_train_step(lm_task(student, teacher, thread_carry=True, device=dev), tx,
                               quant=QuantSpec(bits=4), distill=DistillSpec(0.5, 2.0),
                               device=dev)
        launches, metrics = [], []
        for batch in _windows(12, n=2):
            n0 = fake_quant_buckets.launches
            state, m = step(state, batch, 0)
            launches.append(fake_quant_buckets.launches - n0)
            metrics.append(m)
        runs[dev] = (state, metrics, launches)
    assert runs["cuda"][2] == [1, 1] and runs["cpu"][2] == [0, 0]
    for mc, mg in zip(runs["cpu"][1], runs["cuda"][1]):
        for k, v in mc.items():
            np.testing.assert_allclose(float(mg[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    cpu, card = runs["cpu"][0], runs["cuda"][0]
    for n, p in cpu.params.items():
        _close(card.params[n].detach().cpu(), p.detach(), n, rtol=W_RTOL, atol=W_ATOL)
    for who in ("student", "teacher"):
        _close_carry([tuple(t.cpu() for t in s) for s in card.carry[who]], cpu.carry[who],
                     rtol=W_RTOL, atol=W_ATOL)
