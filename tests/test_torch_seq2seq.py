"""The PyTorch port's dense seq2seq model against the flax one, on the same
weights (carried across by ``convert.params_from_numpy``), at f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_distillation_tpu.models import make_seq2seq as jax_make_seq2seq
from quantized_distillation_tpu_torch.convert import params_from_numpy, params_to_numpy
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig, make_seq2seq

torch.set_num_threads(2)

ATOL = 1e-5  # f32, summation order only


def _twin(attn_type="general", seed=0):
    """A seeded flax model and the port model with the same weights."""
    jm = jax_make_seq2seq(
        "student_small", 50, 60, hidden=48, embed_dim=24, dropout=0.0,
        num_layers=2, attn_type=attn_type,
    )
    src = np.array([[5, 6, 7, 8, 9], [9, 10, 11, 0, 0], [4, 0, 0, 0, 0]], np.int32)
    sl = np.array([5, 3, 1], np.int32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(src), jnp.asarray(sl), jnp.ones((3, 2), jnp.int32))
    tree = jax.tree.map(np.asarray, v["params"])
    tm = Seq2Seq(Seq2SeqConfig(**dataclasses.asdict(jm.cfg)), device="cpu")
    tm.load_params(params_from_numpy(tree))
    return jm, v, tm, tree, src, sl


@pytest.fixture(scope="module")
def twin():
    return _twin()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_params_round_trip(twin):
    _, _, tm, tree, _, _ = twin
    back = params_to_numpy(tm)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_encoder_outputs_and_final_carry_ragged(twin):
    jm, v, tm, _, src, sl = twin
    jo, jmask, (jfin, jfeed) = jm.apply(v, jnp.asarray(src), jnp.asarray(sl), method=jm.encode)
    to, tmask, (tfin, tfeed) = tm.encode(_t(src).long(), _t(sl))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for (jc, jh), (tc, th) in zip(jfin, tfin):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_array_equal(tfeed.numpy(), np.asarray(jfeed))


@pytest.mark.parametrize("attn_type", ["general", "dot"])
def test_decode_steps_match_flax(attn_type):
    jm, v, tm, _, src, sl = _twin(attn_type, seed=1)
    jo, jmask, jstate = jm.apply(v, jnp.asarray(src), jnp.asarray(sl), method=jm.encode)
    to, tmask, tstate = tm.encode(_t(src).long(), _t(sl))
    for tok in ([1, 1, 1], [7, 3, 59], [2, 40, 5]):
        jstate, jl = jm.apply(v, jstate, jnp.asarray(tok, jnp.int32), jo, jmask, method=jm.decode_step)
        tstate, tl = tm.decode_step(tstate, torch.tensor(tok), to, tmask)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_teacher_forced_forward_matches_flax(twin):
    jm, v, tm, _, src, sl = twin
    tgt = np.array([[1, 5, 6, 7], [1, 8, 2, 0], [1, 3, 3, 3]], np.int32)
    jl = jm.apply(v, jnp.asarray(src), jnp.asarray(sl), jnp.asarray(tgt))
    tl = tm(_t(src).long(), _t(sl), _t(tgt).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_seeded_init_is_device_independent_and_reproducible():
    a = make_seq2seq("student_small", 30, 40, hidden=16, embed_dim=8, device="cpu", seed=3)
    b = make_seq2seq("student_small", 30, 40, hidden=16, embed_dim=8, device="cpu", seed=3)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert a.generator_kernel.std() > 0


def test_bidirectional_not_ported():
    # ported now (tests/test_torch_beam_extras.py holds it to JAX): two
    # half-width cells a layer, and an odd width raises as in the JAX package
    cfg = Seq2SeqConfig(src_vocab=10, tgt_vocab=10, hidden=8, embed_dim=4, bidirectional=True)
    m = Seq2Seq(cfg, device="cpu")
    assert len(m.encoder.cells) == 2 * cfg.num_layers and m.encoder.cells[0].wh.shape == (4, 16)
    with pytest.raises(ValueError, match="even hidden"):
        Seq2Seq(dataclasses.replace(cfg, hidden=7), device="cpu")
