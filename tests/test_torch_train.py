"""The PyTorch port's training slice against the JAX package's, on the same
weights and inputs (numpy, from seeds), at small widths: H = 48, not a
multiple of the 256-weight bucket, so a fused LSTM gate tensor bucketed
as one would quantize differently from the flax leaves.

Tolerances (f32 on the CPU, summation order differs between XLA and
PyTorch): fake-quant levels exactly and values within 2e-6 (JAX's own);
losses and metrics within rtol 1e-5; gradients within 1e-4 of each leaf's
largest |gradient|; optimizer parameters within rtol 1e-5, atol 1e-7.

Tests marked ``gpu`` run a train step on the card against the CPU; they
skip where PyTorch sees no card. JAX is imported inside the CPU tests'
fixtures, so ``pytest -m gpu`` runs without JAX.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.convert import (
    codebooks_from_numpy,
    codebooks_to_numpy,
    flax_leaves,
    params_from_numpy,
    params_to_numpy,
)
from quantized_distillation_tpu_torch.kernels import fake_quant_buckets
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig, make_seq2seq
from quantized_distillation_tpu_torch.models.seq2seq import dropout
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    evaluate,
    fit,
    losses,
    make_eval_step,
    make_train_step,
    nmt_task,
)
from quantized_distillation_tpu_torch.train import quantize_tree as qt
from quantized_distillation_tpu_torch.train.manager import ExperimentManager
from quantized_distillation_tpu_torch.train.trainer import (
    CODEBOOK_PREFIX,
    as_batch,
    loss_and_grads,
)
from quantized_distillation_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(2)

V = 64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's largest |gradient|
VALUE_ATOL = 2e-6


def _flat(tree, prefix=""):
    """Nested dict → {'a/b/c': leaf}."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _batch(seed=0, b=3, ts=5, tt=4):
    rng = np.random.default_rng(seed)
    src_len = np.array([ts, ts - 2, 1][:b], np.int32)
    mask = np.ones((b, tt), np.float32)
    mask[1, -1] = 0.0  # target padding
    mask[-1, 2:] = 0.0
    return {
        "src": rng.integers(4, V, (b, ts)).astype(np.int32),
        "src_len": src_len,
        "tgt_in": rng.integers(1, V, (b, tt)).astype(np.int32),
        "tgt_out": rng.integers(1, V, (b, tt)).astype(np.int32),
        "tgt_mask": mask,
    }


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import DistillSpec as JDistill
    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.config import TrainConfig as JTrainConfig
    from quantized_distillation_tpu.models import make_seq2seq as jmake
    from quantized_distillation_tpu.train import loops, trainer
    from quantized_distillation_tpu.train import losses as jlosses
    from quantized_distillation_tpu.train import quantize_tree as jqt
    from quantized_distillation_tpu.train import tasks

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Quant=JQuant, Distill=JDistill, TrainConfig=JTrainConfig,
        make=jmake, trainer=trainer, tasks=tasks, loops=loops, losses=jlosses, qt=jqt,
    )


@pytest.fixture(scope="module")
def twin(jx):
    """Flax student and teacher, and port models with the same weights."""
    b = _batch()
    args = [jx.jnp.asarray(b[k]) for k in ("src", "src_len", "tgt_in")]
    js = jx.make("student_small", V, V, hidden=48, embed_dim=24, num_layers=2, dropout=0.0)
    jt = jx.make("student_small", V, V, hidden=40, embed_dim=16, num_layers=2, dropout=0.0)
    sv = js.init(jx.jax.random.PRNGKey(1), *args)
    tv = jt.init(jx.jax.random.PRNGKey(2), *args)

    def port(jm, v):
        cfg = Seq2SeqConfig(**dataclasses.asdict(jm.cfg))
        return Seq2Seq(cfg, device="cpu").load_params(
            params_from_numpy(jx.jax.tree.map(np.asarray, v["params"])))

    return types.SimpleNamespace(js=js, jt=jt, sv=sv, tv=tv, student=port(js, sv),
                                 teacher=port(jt, tv))


def _port_params(twin):
    """A fresh copy of the port student's parameters (the trainer updates
    the tensors it is given in place)."""
    return {n: p.detach().clone() for n, p in twin.student.named_parameters()}


# ------------------------------------------------------------ quantize_tree


class TestQuantizeTree:
    def test_quantizable_paths_and_sizes_match_jax(self, jx, twin):
        spec = QuantSpec(bits=4)
        jflat = jx.jax.tree_util.tree_flatten_with_path(twin.sv["params"])[0]
        jpaths = [jx.qt.path_str(p) for p, _ in jflat]
        want = {jx.qt.path_str(p) for p, leaf in jflat
                if jx.qt.is_quantizable(jx.qt.path_str(p), leaf, jx.Quant(bits=4))}
        params = _port_params(twin)
        assert [p for p, _ in flax_leaves(params)] == jpaths  # the flax leaf order
        assert {p for p, x in flax_leaves(params) if qt.is_quantizable(p, x, spec)} == want
        assert qt.param_sizes(params) == jx.qt.param_sizes(twin.sv["params"])
        assert len(jpaths) == 54 and len(want) == 37  # as student_medium's tree

    def test_index_streams_match_jax(self, jx, twin):
        got = qt.index_streams(_port_params(twin), QuantSpec(bits=4))
        want = jx.qt.index_streams(twin.sv["params"], jx.Quant(bits=4))
        assert got.keys() == want.keys()
        for p in want:
            np.testing.assert_array_equal(got[p], want[p])

    @pytest.mark.parametrize("bits_map", [None, "mixed"])
    @pytest.mark.parametrize("scaling", ["linear", "absmax"])
    def test_tree_values_match_jax_per_leaf(self, jx, twin, bits_map, scaling):
        params = _port_params(twin)
        spec, jspec = QuantSpec(bits=4, scaling=scaling), jx.Quant(bits=4, scaling=scaling)
        bm = None
        if bits_map == "mixed":
            paths = [p for p, x in flax_leaves(params) if qt.is_quantizable(p, x, spec)]
            bm = {p: (2 if i % 2 else 4) for i, p in enumerate(paths)}
        jhard = _flat(jx.qt.quantize_tree_hard(twin.sv["params"], jspec, bits_map=bm))
        jpallas = jx.qt._fused_fake_quant_values(twin.sv["params"], jspec, bm, force=True)
        n0 = fake_quant_buckets.launches
        ste = _flat(params_to_numpy(qt.ste_quantize_tree(params, spec, bits_map=bm)))
        hard = _flat(params_to_numpy(qt.quantize_tree_hard(params, spec, bits_map=bm)))
        assert fake_quant_buckets.launches == n0  # CPU tensors run the plain version
        orig = _flat(params_to_numpy(params))
        for path, want in jhard.items():
            if path not in jpallas:  # biases: untouched
                np.testing.assert_array_equal(ste[path], orig[path])
                np.testing.assert_array_equal(hard[path], orig[path])
                continue
            bits = bm[path] if bm else 4
            for got in (ste[path], hard[path]):
                for ref in (want, np.asarray(jpallas[path])):
                    np.testing.assert_allclose(got, ref, rtol=0, atol=VALUE_ATOL)
                    np.testing.assert_array_equal(
                        np.asarray(jx.qt.uniform.quantize(jx.jnp.asarray(got), bits,
                                                          scaling=scaling).levels),
                        np.asarray(jx.qt.uniform.quantize(jx.jnp.asarray(ref), bits,
                                                          scaling=scaling).levels))

    def test_fused_gates_quantize_per_leaf(self, twin):
        # bucketing the fused [in, 4H] tensor as one would give other values
        params = _port_params(twin)
        spec = QuantSpec(bits=2)
        got = qt.quantize_tree_hard(params, spec)["decoder.cells.0.wi"]
        from quantized_distillation_tpu_torch.ops import uniform

        whole = uniform.fake_quant(params["decoder.cells.0.wi"], 2)
        assert not torch.allclose(got, whole)
        assert torch.equal(got[:, :48], uniform.fake_quant(params["decoder.cells.0.wi"][:, :48], 2))

    def test_ste_gradient_flows_to_master_weights(self, twin):
        params = {n: p.requires_grad_(True) for n, p in _port_params(twin).items()}
        q = qt.ste_quantize_tree(params, QuantSpec(bits=2))
        assert q["generator_bias"] is params["generator_bias"]
        assert not torch.equal(q["generator_kernel"], params["generator_kernel"])
        sum(t.sum() for t in q.values()).backward()
        for p in params.values():
            assert torch.equal(p.grad, torch.ones_like(p))

    def test_stochastic_and_codebook(self, twin):
        params = _port_params(twin)
        spec = QuantSpec(bits=4, stochastic=True)
        with pytest.raises(ValueError, match="Generator"):
            qt.ste_quantize_tree(params, spec)
        a = qt.ste_quantize_tree(params, spec, torch.Generator().manual_seed(0))
        b = qt.ste_quantize_tree(params, spec, torch.Generator().manual_seed(0))
        assert all(torch.equal(a[n], b[n]) for n in a)
        # hard (deployment) values round deterministically, as in JAX
        hard = qt.quantize_tree_hard(params, spec)
        assert all(torch.equal(hard[n], t) for n, t in qt.quantize_tree_hard(
            params, QuantSpec(bits=4)).items())
        # learned codebooks: one per quantizable leaf; the hard values need them
        books = qt.init_codebook_tree(params, spec)
        assert len(books) == 37 and all(b.shape == (16,) for b in books.values())
        with pytest.raises(ValueError, match="codebooks"):
            qt.quantize_tree_hard(params, QuantSpec(method="codebook"))
        hard = qt.quantize_tree_hard(params, QuantSpec(method="codebook"), books)
        # uniform-grid points snap like the uniform quantizer, up to rounding
        ref = qt.quantize_tree_hard(params, QuantSpec(bits=4))
        assert all(torch.allclose(hard[n], ref[n], atol=1e-5) for n in hard)

    @pytest.mark.parametrize("init", ["uniform", "quantile"])
    def test_codebook_tree_matches_jax(self, jx, twin, init):
        params = _port_params(twin)
        spec = QuantSpec(bits=4, method="codebook")
        jspec = jx.Quant(bits=4, method="codebook")
        want = jx.qt.init_codebook_tree(twin.sv["params"], jspec, init)
        got = qt.init_codebook_tree(params, spec, init)
        assert list(got) == list(want)  # the same keys, in flax leaf order
        for path, w in want.items():
            np.testing.assert_allclose(got[path].numpy(), np.asarray(w), rtol=0,
                                       atol=np.spacing(np.float32(1)), err_msg=path)
        assert codebooks_to_numpy(codebooks_from_numpy(want)).keys() == want.keys()
        # quantize with JAX's own points, carried across unchanged
        books = codebooks_from_numpy(jx.jax.tree.map(np.asarray, want))
        jhard = _flat(jx.qt.quantize_tree_hard(twin.sv["params"], jspec, want))
        hard = _flat(params_to_numpy(qt.quantize_tree_hard(params, spec, books)))
        ste = _flat(params_to_numpy(qt.ste_codebook_tree(params, books, spec)))
        for path, w in jhard.items():
            np.testing.assert_allclose(hard[path], w, rtol=0, atol=VALUE_ATOL, err_msg=path)
            np.testing.assert_array_equal(ste[path], hard[path])
        jstreams = jx.qt.index_streams(twin.sv["params"], jspec, want)
        streams = qt.index_streams(params, spec, books)
        assert streams.keys() == jstreams.keys()
        for path, w in jstreams.items():
            np.testing.assert_array_equal(streams[path], w)


# ------------------------------------------------------------------- losses


class TestLosses:
    def test_losses_match_jax_with_mask(self, jx):
        rng = np.random.default_rng(0)
        s = rng.standard_normal((3, 4, 11)).astype(np.float32) * 3
        t = rng.standard_normal((3, 4, 11)).astype(np.float32) * 3
        y = rng.integers(0, 11, (3, 4)).astype(np.int32)
        m = (rng.random((3, 4)) > 0.3).astype(np.float32)
        S, T, Y, M = (torch.from_numpy(a) for a in (s, t, y, m))
        js, jt, jy, jm = (jx.jnp.asarray(a) for a in (s, t, y, m))
        pairs = [
            (losses.cross_entropy(S, Y), jx.losses.cross_entropy(js, jy)),
            (losses.masked_cross_entropy(S, Y, M), jx.losses.masked_cross_entropy(js, jy, jm)),
            (losses.kd_kl(S, T, 2.0), jx.losses.kd_kl(js, jt, 2.0)),
            (losses.kd_kl(S, T, 2.0, M), jx.losses.kd_kl(js, jt, 2.0, jm)),
            (losses.distillation_loss(S, T, Y, DistillSpec(0.5, 2.0), M),
             jx.losses.distillation_loss(js, jt, jy, jx.Distill(0.5, 2.0), jm)),
            (losses.distillation_loss(S, None, Y, DistillSpec(), M),
             jx.losses.distillation_loss(js, None, jy, jx.Distill(), jm)),
            (losses.accuracy(S, Y), jx.losses.accuracy(js, jy)),
            *zip(losses.perplexity_terms(S, Y, M), jx.losses.perplexity_terms(js, jy, jm)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=1e-6)


# ------------------------------------------------------------- train step


def _jax_loss_and_grads(jx, twin, batch, quant, distill):
    task = jx.tasks.nmt_task(twin.js, twin.jt, twin.tv)
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        q = jx.trainer.quantized_params(params, quant, None, None)
        logits, _ = task.student_forward({"params": q}, jb, True,
                                         {"dropout": jx.jax.random.PRNGKey(0)})
        loss, metrics = task.loss_and_metrics(logits, task.teacher_forward(jb), jb, distill)
        return loss, metrics

    (loss, metrics), grads = jx.jax.value_and_grad(loss_fn, has_aux=True)(twin.sv["params"])
    return float(loss), {k: float(v) for k, v in metrics.items()}, _flat(grads)


class TestKDStep:
    @pytest.mark.parametrize("bits", [4, None])
    def test_loss_metrics_and_grads_match_jax(self, jx, twin, bits):
        batch = _batch(seed=3)
        quant = QuantSpec(bits=bits) if bits else None
        jquant = jx.Quant(bits=bits) if bits else None
        jloss, jmetrics, jgrads = _jax_loss_and_grads(jx, twin, batch, jquant, jx.Distill(0.5, 2.0))
        task = nmt_task(twin.student, twin.teacher, device="cpu")
        params = {n: p.requires_grad_(True) for n, p in _port_params(twin).items()}
        loss, metrics, grads, _ = loss_and_grads(
            task, params, as_batch(batch, torch.device("cpu")), quant=quant,
            distill=DistillSpec(0.5, 2.0))
        np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL)
        got = _flat(params_to_numpy(grads))
        assert got.keys() == jgrads.keys()
        for path, want in jgrads.items():
            tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(got[path], want, rtol=0, atol=tol, err_msg=path)

    def test_sgd_step_matches_jax_train_step(self, jx, twin):
        # SGD's update is linear in the gradient, so whole steps compare
        # tightly (Adam's g/(sqrt(v)+eps) is held to optax on its own below)
        batch = _batch(seed=4)
        cfg = dict(learning_rate=0.5, clip_norm=0.05, optimizer="sgd")
        jtx = jx.trainer.build_optimizer(jx.TrainConfig(**cfg))
        jstate = jx.trainer.create_train_state(twin.sv["params"], jtx, quant=jx.Quant(bits=4))
        jstep = jx.trainer.make_train_step(
            jx.tasks.nmt_task(twin.js, twin.jt, twin.tv), jtx, quant=jx.Quant(bits=4),
            distill=jx.Distill(0.5, 2.0), donate=False)
        tx = build_optimizer(TrainConfig(**cfg))
        state = create_train_state(_port_params(twin), tx, quant=QuantSpec(bits=4), device="cpu")
        step = make_train_step(nmt_task(twin.student, twin.teacher, device="cpu"), tx,
                               quant=QuantSpec(bits=4), distill=DistillSpec(0.5, 2.0),
                               device="cpu")
        for _ in range(2):
            jstate, jm = jstep(jstate, {k: jx.jnp.asarray(v) for k, v in batch.items()},
                               jx.jax.random.PRNGKey(0))
            state, m = step(state, batch, 0)
            assert set(m) == set(jm) == {"loss", "grad_norm", "nll_sum", "n_tokens"}
            for k in jm:
                np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL)
        assert state.step == 2
        want = _flat(jx.jax.tree.map(np.asarray, jstate.params))
        got = _flat(params_to_numpy(state.params))
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-6, err_msg=path)

    def test_nmt_kd_training_decreases_loss(self):
        # tests/test_trainer.py::TestNMTTraining::test_nmt_kd_step, on the port
        student = make_seq2seq("student_small", 30, 40, device="cpu", seed=1)
        teacher = make_seq2seq("student_small", 30, 40, hidden=160, embed_dim=160,
                               device="cpu", seed=2)
        batch = {
            "src": np.array([[5, 6, 7, 0], [8, 9, 4, 3]]), "src_len": np.array([3, 4]),
            "tgt_in": np.array([[1, 5, 6], [1, 7, 8]]),
            "tgt_out": np.array([[5, 6, 2], [7, 8, 2]]), "tgt_mask": np.ones((2, 3)),
        }
        quant, distill = QuantSpec(bits=4), DistillSpec(weight=0.5, temperature=2.0)
        tx = build_optimizer(TrainConfig(learning_rate=5e-3, clip_norm=5.0))
        state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                   device="cpu")
        step = make_train_step(nmt_task(student, teacher, device="cpu"), tx, quant=quant,
                               distill=distill, device="cpu")
        out = []
        for _ in range(10):
            state, m = step(state, batch, 0)
            out.append(float(m["loss"]))
        assert out[-1] < out[0] and np.isfinite(out).all()

    def test_unported_modes_raise(self, twin):
        # the codebook modes are ported: without a codebook QuantSpec they
        # have nothing to train, and an unknown mode is refused
        tx = build_optimizer(TrainConfig())
        task = nmt_task(twin.student, twin.teacher, device="cpu")
        for fn in (
            lambda: create_train_state(_port_params(twin), tx, mode="codebooks", device="cpu"),
            lambda: make_train_step(task, tx, mode="joint", quant=QuantSpec(bits=4),
                                    device="cpu"),
            lambda: make_train_step(task, tx, mode="points", device="cpu"),
        ):
            with pytest.raises(ValueError, match="mode"):
                fn()
        cb = QuantSpec(bits=4, method="codebook")
        state = create_train_state(_port_params(twin), tx, quant=cb, mode="codebooks",
                                   device="cpu")
        assert all(not p.requires_grad for p in state.params.values())
        assert all(b.requires_grad for b in state.codebooks.values())
        # the weights hold no optimizer state; joint holds both, under unclashing names
        assert set(state.opt_state.mu) == {CODEBOOK_PREFIX + p for p in state.codebooks}
        joint = create_train_state(_port_params(twin), tx, quant=cb, mode="joint", device="cpu")
        assert set(joint.opt_state.mu) == set(joint.params) | set(state.opt_state.mu)
        assert len(joint.opt_state.mu) == len(joint.params) + 37
        make_train_step(task, tx, quant=cb, mode="codebooks", device="cpu")
        # the JAX package's check: a reduced-precision all-reduce needs a mesh
        with pytest.raises(ValueError, match="requires a mesh"):
            make_train_step(task, tx, grad_reduce_dtype=torch.float16, device="cpu")


def _jax_codebook_loss_and_grads(jx, twin, batch, books, mode, distill):
    """The JAX step's value_and_grad over what ``mode`` trains."""
    task = jx.tasks.nmt_task(twin.js, twin.jt, twin.tv)
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    quant = jx.Quant(bits=4, method="codebook")
    trainable = jx.trainer._trainable(
        jx.trainer.TrainState(0, twin.sv["params"], None, None, books), mode)

    def loss_fn(tr):
        st = jx.trainer._with_trainable(
            jx.trainer.TrainState(0, twin.sv["params"], None, None, books), mode, tr)
        params = st.params if mode != "codebooks" else jx.jax.lax.stop_gradient(st.params)
        q = jx.trainer.quantized_params(params, quant, st.codebooks, None)
        logits, _ = task.student_forward({"params": q}, jb, True,
                                         {"dropout": jx.jax.random.PRNGKey(0)})
        return task.loss_and_metrics(logits, task.teacher_forward(jb), jb, distill)

    (loss, metrics), grads = jx.jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    if mode == "joint":
        pgrads, bgrads = grads
    else:
        pgrads, bgrads = None, grads
    return float(loss), {k: float(v) for k, v in metrics.items()}, pgrads, bgrads


class TestCodebookKDStep:
    """Differentiable quantization: a 4-bit codebook KD step matched to the
    JAX package's, from JAX's own quantile-initialised codebooks."""

    @pytest.mark.parametrize("mode", ["joint", "codebooks"])
    def test_loss_metrics_and_grads_match_jax(self, jx, twin, mode):
        batch = _batch(seed=11)
        jbooks = jx.qt.init_codebook_tree(twin.sv["params"], jx.Quant(bits=4, method="codebook"),
                                          "quantile")
        jloss, jmetrics, jpgrads, jbgrads = _jax_codebook_loss_and_grads(
            jx, twin, batch, jbooks, mode, jx.Distill(0.5, 2.0))
        books = {p: t.requires_grad_(True)
                 for p, t in codebooks_from_numpy(jx.jax.tree.map(np.asarray, jbooks)).items()}
        params = {n: p.requires_grad_(mode == "joint") for n, p in _port_params(twin).items()}
        task = nmt_task(twin.student, twin.teacher, device="cpu")
        loss, metrics, grads, _ = loss_and_grads(
            task, params, as_batch(batch, torch.device("cpu")),
            quant=QuantSpec(bits=4, method="codebook"), distill=DistillSpec(0.5, 2.0),
            codebooks=books, mode=mode)
        np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL)
        bgrads = {n[len(CODEBOOK_PREFIX):]: g for n, g in grads.items()
                  if n.startswith(CODEBOOK_PREFIX)}
        assert bgrads.keys() == jbgrads.keys()
        for path, want in jbgrads.items():
            want = np.asarray(want)
            tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(bgrads[path].numpy(), want, rtol=0, atol=tol, err_msg=path)
        pgrads = {n: g for n, g in grads.items() if not n.startswith(CODEBOOK_PREFIX)}
        if mode == "codebooks":
            assert pgrads == {}
            return
        got = _flat(params_to_numpy(pgrads))
        for path, want in _flat(jpgrads).items():
            tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(got[path], want, rtol=0, atol=tol, err_msg=path)

    @pytest.mark.parametrize("mode", ["joint", "codebooks"])
    def test_sgd_steps_match_jax_train_step(self, jx, twin, mode):
        batch = _batch(seed=12)
        cfg = dict(learning_rate=0.5, clip_norm=0.05, optimizer="sgd")
        quant, jquant = QuantSpec(bits=4, method="codebook"), jx.Quant(bits=4, method="codebook")
        jtx = jx.trainer.build_optimizer(jx.TrainConfig(**cfg))
        jstate = jx.trainer.create_train_state(twin.sv["params"], jtx, quant=jquant, mode=mode)
        jstep = jx.trainer.make_train_step(
            jx.tasks.nmt_task(twin.js, twin.jt, twin.tv), jtx, quant=jquant,
            distill=jx.Distill(0.5, 2.0), mode=mode, donate=False)
        tx = build_optimizer(TrainConfig(**cfg))
        state = create_train_state(_port_params(twin), tx, quant=quant, mode=mode, device="cpu")
        w0 = {n: p.detach().clone() for n, p in state.params.items()}
        b0 = {p: b.detach().clone() for p, b in state.codebooks.items()}
        step = make_train_step(nmt_task(twin.student, twin.teacher, device="cpu"), tx,
                               quant=quant, distill=DistillSpec(0.5, 2.0), mode=mode,
                               device="cpu")
        for _ in range(2):
            jstate, jm = jstep(jstate, {k: jx.jnp.asarray(v) for k, v in batch.items()},
                               jx.jax.random.PRNGKey(0))
            state, m = step(state, batch, 0)
            assert set(m) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
        for path, w in jstate.codebooks.items():
            np.testing.assert_allclose(state.codebooks[path].detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6, err_msg=path)
        assert any(not torch.equal(state.codebooks[p], b0[p]) for p in b0)
        if mode == "codebooks":  # frozen: bit for bit
            assert all(torch.equal(state.params[n], w0[n]) for n in w0)
        else:
            want = _flat(jx.jax.tree.map(np.asarray, jstate.params))
            got = _flat(params_to_numpy(state.params))
            for path, w in want.items():
                np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-6, err_msg=path)
        # eval on the hard-quantized weights with the trained codebooks
        jeval = jx.trainer.make_eval_step(jx.tasks.nmt_task(twin.js, twin.jt, twin.tv),
                                          quant=jquant)
        ev = make_eval_step(nmt_task(twin.student, twin.teacher, device="cpu"), quant=quant,
                            device="cpu")
        jm = jeval(jstate, {k: jx.jnp.asarray(v) for k, v in batch.items()})
        m = ev(state, batch)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)

    def test_joint_codebook_training_decreases_loss(self):
        student = make_seq2seq("student_small", 30, 40, device="cpu", seed=1)
        teacher = make_seq2seq("student_small", 30, 40, hidden=160, embed_dim=160,
                               device="cpu", seed=2)
        batch = {
            "src": np.array([[5, 6, 7, 0], [8, 9, 4, 3]]), "src_len": np.array([3, 4]),
            "tgt_in": np.array([[1, 5, 6], [1, 7, 8]]),
            "tgt_out": np.array([[5, 6, 2], [7, 8, 2]]), "tgt_mask": np.ones((2, 3)),
        }
        quant = QuantSpec(bits=4, method="codebook")
        tx = build_optimizer(TrainConfig(learning_rate=5e-3, clip_norm=5.0))
        state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                   mode="joint", codebook_init="quantile", device="cpu")
        step = make_train_step(nmt_task(student, teacher, device="cpu"), tx, quant=quant,
                               distill=DistillSpec(0.5, 2.0), mode="joint", device="cpu")
        out = []
        for _ in range(10):
            state, m = step(state, batch, 0)
            out.append(float(m["loss"]))
        assert out[-1] < out[0] and np.isfinite(out).all()


# ---------------------------------------------------------------- optimizer


def _optax_params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal(11).astype(np.float32)}


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "momentum"])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "step"])
@pytest.mark.parametrize("clip_wd", [(None, 0.0), (0.5, 1e-2)])
def test_build_optimizer_matches_optax(jx, optimizer, schedule, clip_wd):
    import optax

    cfg = dict(learning_rate=0.05, optimizer=optimizer, lr_schedule=schedule, epochs=2,
               warmup_steps=2, lr_decay_every=2, clip_norm=clip_wd[0],
               weight_decay=clip_wd[1])
    jtx = jx.trainer.build_optimizer(jx.TrainConfig(**cfg), steps_per_epoch=3)
    tx = build_optimizer(TrainConfig(**cfg), steps_per_epoch=3)
    p0 = _optax_params(0)
    jp = {k: jx.jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jtx.init(jp), tx.init(tp)
    for i in range(7):
        g = _optax_params(10 + i)
        ju, js = jtx.update({k: jx.jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")


def test_cosine_schedule_starts_at_zero_and_unknown_optimizer_raises():
    tx = build_optimizer(TrainConfig(lr_schedule="cosine", epochs=4), steps_per_epoch=5)
    assert tx.schedule(0) == 0.0 and tx.schedule(1) == pytest.approx(1e-3)
    assert tx.schedule(20) == pytest.approx(0.0, abs=1e-12)
    with pytest.raises(ValueError, match="optimizer"):
        build_optimizer(TrainConfig(optimizer="lamb"))


# --------------------------------------------------------------- eval, fit


def test_eval_step_and_evaluate_match_jax(jx, twin):
    batches = [_batch(seed=5), _batch(seed=6, b=2)]
    jtask = jx.tasks.nmt_task(twin.js, twin.jt, twin.tv)
    jtx = jx.trainer.build_optimizer(jx.TrainConfig())
    jstate = jx.trainer.create_train_state(twin.sv["params"], jtx)
    task = nmt_task(twin.student, twin.teacher, device="cpu")
    tx = build_optimizer(TrainConfig())
    state = create_train_state(_port_params(twin), tx, device="cpu")
    for quant, jquant in ((QuantSpec(bits=2), jx.Quant(bits=2)), (None, None)):
        jeval = jx.trainer.make_eval_step(jtask, quant=jquant)
        ev = make_eval_step(task, quant=quant, device="cpu")
        jm, m = jeval(jstate, {k: jx.jnp.asarray(v) for k, v in batches[0].items()}), \
            ev(state, batches[0])
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL)
        want = jx.loops.evaluate(jeval, jstate, batches)
        got = evaluate(ev, state, batches)
        assert set(got) == set(want) == {"perplexity"}
        np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=LOSS_RTOL)


def test_fit_trains_logs_and_evaluates(twin, tmp_path):
    task = nmt_task(twin.student, twin.teacher, device="cpu")
    cfg = TrainConfig(epochs=2, learning_rate=5e-3, log_every=2, eval_every=3,
                      quant=QuantSpec(bits=4), distill=DistillSpec(0.5, 2.0))
    tx = build_optimizer(cfg)
    state = create_train_state(_port_params(twin), tx, quant=cfg.quant, device="cpu")
    batches = [_batch(seed=s) for s in (7, 8)]
    log = tmp_path / "m.jsonl"
    logger = MetricsLogger(str(log), echo=False)
    state = fit(task, state, cfg, lambda epoch: iter(batches),
                eval_batches=lambda: iter(batches[:1]), tx=tx, logger=logger, device="cpu")
    logger.close()
    assert state.step == 4
    events = [json.loads(line)["event"] for line in log.read_text().splitlines()]
    # steps 1-2 in epoch 0, 3-4 in epoch 1: logs at steps 2 and 4, an eval at step 3
    assert events == ["train", "epoch", "eval", "train", "epoch"]
    mgr = ExperimentManager(str(tmp_path / "runs"))
    mgr.add_new_model("student")
    state = fit(task, state, cfg, lambda epoch: iter(batches), tx=tx, manager=mgr,
                model_name="student", device="cpu")
    assert mgr.latest_step("student") == state.step == 8  # saved after each epoch
    assert sorted(p.name for p in (tmp_path / "runs/student/checkpoints").iterdir()) == [
        "6.pt", "8.pt"]


# ------------------------------------------------------------------ dropout


def test_dropout_masks_scale_and_needs_a_generator():
    x = torch.ones(400, 500)
    y = dropout(x, 0.3, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert dropout(x, 0.3, False, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.3, True, None)


def test_train_mode_dropout_is_seeded_and_eval_is_dropout_free(twin):
    cfg = dataclasses.replace(twin.student.cfg, dropout=0.3)
    m = Seq2Seq(cfg, device="cpu").load_params(params_from_numpy(params_to_numpy(twin.student)))
    b = as_batch(_batch(), torch.device("cpu"))
    args = (b["src"], b["src_len"], b["tgt_in"])
    a1 = m(*args, train=True, generator=torch.Generator().manual_seed(3))
    a2 = m(*args, train=True, generator=torch.Generator().manual_seed(3))
    a3 = m(*args, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a1, a2) and not torch.allclose(a1, a3)
    assert torch.equal(m(*args), twin.student(*args))


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = _batch(seed=9)
    runs = {}
    for dev in ("cpu", "cuda"):
        student = make_seq2seq("student_small", V, V, hidden=48, embed_dim=24, num_layers=2,
                               dropout=0.0, device=dev, seed=1)
        teacher = make_seq2seq("student_small", V, V, hidden=40, embed_dim=16, num_layers=2,
                               dropout=0.0, device=dev, seed=2)
        tx = build_optimizer(TrainConfig(optimizer="sgd", learning_rate=0.5, clip_norm=5.0))
        state = create_train_state(dict(student.named_parameters()), tx,
                                   quant=QuantSpec(bits=4), device=dev)
        step = make_train_step(nmt_task(student, teacher, device=dev), tx,
                               quant=QuantSpec(bits=4), distill=DistillSpec(0.5, 2.0),
                               device=dev)
        n0 = fake_quant_buckets.launches
        state, m = step(state, batch, 0)
        runs[dev] = (state, m, fake_quant_buckets.launches - n0)
    assert runs["cuda"][2] == 1 and runs["cpu"][2] == 0
    for k, v in runs["cpu"][1].items():
        np.testing.assert_allclose(float(runs["cuda"][1][k]), float(v), rtol=LOSS_RTOL)
    for n, p in runs["cpu"][0].params.items():
        np.testing.assert_allclose(runs["cuda"][0].params[n].detach().cpu().numpy(),
                                   p.detach().numpy(), rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.gpu
def test_gpu_joint_codebook_step_matches_cpu(cuda):
    """One joint codebook KD step: card against CPU from the same weights.
    The codebook gradients are scatter-adds that the card sums with atomics
    in no fixed order: within 1e-4 of each tensor's largest |gradient|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = _batch(seed=13)
    quant = QuantSpec(bits=4, method="codebook")
    runs = {}
    for dev in ("cpu", "cuda"):
        student = make_seq2seq("student_small", V, V, hidden=48, embed_dim=24, num_layers=2,
                               dropout=0.0, device=dev, seed=1)
        teacher = make_seq2seq("student_small", V, V, hidden=40, embed_dim=16, num_layers=2,
                               dropout=0.0, device=dev, seed=2)
        tx = build_optimizer(TrainConfig(optimizer="sgd", learning_rate=0.5, clip_norm=5.0))
        state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                   mode="joint", codebook_init="quantile", device=dev)
        loss, metrics, grads, _ = loss_and_grads(
            nmt_task(student, teacher, device=dev), state.params,
            as_batch(batch, torch.device(dev)), quant=quant, distill=DistillSpec(0.5, 2.0),
            codebooks=state.codebooks, mode="joint")
        runs[dev] = (dict(metrics, loss=loss), grads)
    for k, v in runs["cpu"][0].items():
        np.testing.assert_allclose(float(runs["cuda"][0][k]), float(v), rtol=LOSS_RTOL)
    assert runs["cuda"][1].keys() == runs["cpu"][1].keys()
    for n, g in runs["cpu"][1].items():
        tol = GRAD_TOL * max(float(g.abs().max()), 1e-12)
        np.testing.assert_allclose(runs["cuda"][1][n].cpu().numpy(), g.numpy(), rtol=0,
                                   atol=tol, err_msg=n)
