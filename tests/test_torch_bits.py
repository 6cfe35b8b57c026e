"""The PyTorch port's automatic bit assignment (``train/bits.py``) against
the JAX package's: ``assign_bits`` exactly (as tests/test_bits_loops.py
pins it), and ``gradient_sensitivities`` of a small seq2seq student within
rtol 1e-5 (f32 gradients summed in another order), keyed by the same flax
paths."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_distillation_tpu.config import QuantSpec as JQuant
from quantized_distillation_tpu.models import make_seq2seq as jmake
from quantized_distillation_tpu.train import bits as jbits
from quantized_distillation_tpu.train import quantize_tree as jqt
from quantized_distillation_tpu.train import tasks as jtasks
from quantized_distillation_tpu_torch.config import QuantSpec
from quantized_distillation_tpu_torch.convert import params_from_numpy
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig
from quantized_distillation_tpu_torch.train import assign_bits, gradient_sensitivities, nmt_task
from quantized_distillation_tpu_torch.train import quantize_tree as qt
from quantized_distillation_tpu_torch.train.trainer import as_batch

torch.set_num_threads(2)

V = 40


@pytest.mark.parametrize(
    "sizes, sens, target",
    [
        ({"a": 1000, "b": 1000, "c": 1000, "d": 1000}, {"a": 10.0, "b": 5.0, "c": 1.0, "d": 0.1}, 4.0),
        ({"a": 10, "b": 10}, {"a": 1.0, "b": 2.0}, 2.0),
        ({"a": 10, "b": 10}, {"a": 1.0, "b": 2.0}, 8.0),
        ({"a": 300, "b": 70, "c": 5000, "x": 9}, {"a": 0.3, "b": 2.0, "c": 0.01}, 3.1),
        ({"a": 0}, {"a": 1.0}, 4.0),
    ],
)
def test_assign_bits_equals_jax(sizes, sens, target):
    got = assign_bits(sizes, sens, target)
    assert got == jbits.assign_bits(sizes, sens, target)
    total = sum(sizes[n] for n in got)
    if total:
        assert sum(sizes[n] * got[n] for n in got) / total <= target + 1e-9


def test_assign_bits_custom_ladder_equals_jax():
    sizes = {f"l{i}": 100 * (i + 1) for i in range(6)}
    sens = {f"l{i}": float((i * 7) % 5) for i in range(6)}
    for allowed in ((2, 8), (3, 4, 6), (8, 2, 4)):
        assert assign_bits(sizes, sens, 4.5, allowed) == jbits.assign_bits(sizes, sens, 4.5, allowed)


def test_gradient_sensitivities_match_jax():
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        mask = np.ones((3, 4), np.float32)
        mask[1, -1] = 0.0
        batches.append({
            "src": rng.integers(4, V, (3, 5)).astype(np.int32),
            "src_len": np.array([5, 3, 2], np.int32),
            "tgt_in": rng.integers(1, V, (3, 4)).astype(np.int32),
            "tgt_out": rng.integers(1, V, (3, 4)).astype(np.int32),
            "tgt_mask": mask,
        })
    jm = jmake("student_small", V, V, hidden=48, embed_dim=24, num_layers=2, dropout=0.0)
    b0 = batches[0]
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(b0["src"]), jnp.asarray(b0["src_len"]),
                jnp.asarray(b0["tgt_in"]))
    jtask = jtasks.nmt_task(jm)

    def jloss(params, batch):
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        logits, _ = jtask.student_forward({"params": params}, jb, False, {})
        return jtask.loss_and_metrics(logits, None, jb, None)[0]

    want = jbits.gradient_sensitivities(jloss, v["params"], batches, JQuant(bits=4))

    student = Seq2Seq(Seq2SeqConfig(**dataclasses.asdict(jm.cfg)), device="cpu").load_params(
        params_from_numpy(jax.tree.map(np.asarray, v["params"])))
    task = nmt_task(student, device="cpu")

    def loss(params, batch):
        b = as_batch(batch, torch.device("cpu"))
        logits, _ = task.student_forward(params, b, False, None)
        return task.loss_and_metrics(logits, None, b, None)[0]

    params = dict(student.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    got = gradient_sensitivities(loss, params, batches, QuantSpec(bits=4))
    assert got.keys() == want.keys() and len(got) == 37
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-5, err_msg=path)
    assert all(torch.equal(params[n], before[n]) and params[n].grad is None for n in params)
    # the sensitivities key a bits_map the quantize-tree transforms read
    bm = assign_bits(qt.param_sizes(params), got, 4.0)
    assert bm == jbits.assign_bits(jqt.param_sizes(v["params"]), want, 4.0)
