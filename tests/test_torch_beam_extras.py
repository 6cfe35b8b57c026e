"""The rest of the port's beam core and model against the JAX package's:
the GNMT coverage penalty, per-hypothesis attention, the ring-history
unroll, greedy decoding, ``tokens_to_sentences``, ``decode_step_attn`` and
the bidirectional encoder (``tests/test_beam.py``'s cases, port vs JAX).

Weights come from the JAX model's init, carried across by
``convert.params_from_numpy``. Tokens must be equal; scores within rtol
1e-5; attention rows within 1e-6 (f32 softmax outputs of the same
products); coverage-penalty values rtol 1e-6, as ``tests/test_beam.py``
states its formula check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_distillation_tpu.config import BeamConfig as JaxBeamConfig
from quantized_distillation_tpu.models import make_seq2seq as jax_make_seq2seq
from quantized_distillation_tpu.serve import beam as jbeam
from quantized_distillation_tpu.serve import infer as jinfer
from quantized_distillation_tpu_torch.config import BeamConfig
from quantized_distillation_tpu_torch.convert import params_from_numpy, params_to_numpy
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig
from quantized_distillation_tpu_torch.serve import (
    beam_search,
    beam_search_packed,
    coverage_penalty,
    greedy_decode,
    pack_decoder,
    reconstruct_attention,
    reconstruct_tokens,
    tokens_to_sentences,
    unroll_ring,
)
from quantized_distillation_tpu_torch.serve.beam import EOS, PAD

torch.set_num_threads(2)

SRC = np.array([[5, 6, 7, 8], [9, 10, 0, 0], [4, 0, 0, 0]], np.int32)
SRC_LEN = np.array([4, 2, 1], np.int32)


def _twin(**overrides):
    """A JAX model at the JAX beam tests' widths and its port on the same
    weights."""
    kw = dict(hidden=64, embed_dim=32, dropout=0.0, **overrides)
    jm = jax_make_seq2seq("student_small", 30, 30, **kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(SRC), jnp.asarray(SRC_LEN),
                jnp.ones((3, 2), jnp.int32))
    params = params_from_numpy(jax.tree.map(np.asarray, v["params"]))
    tm = Seq2Seq(Seq2SeqConfig(**dataclasses.asdict(jm.cfg)), device="cpu").load_params(params)
    return jm, v, tm, params


@pytest.fixture(scope="module")
def twin():
    return _twin()


@pytest.fixture(scope="module")
def bi_twin():
    return _twin(bidirectional=True, num_layers=2)


def _src():
    return torch.from_numpy(SRC).long(), torch.from_numpy(SRC_LEN)


def assert_same(jout, tout):
    assert len(jout) == len(tout)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-5)
    if len(jout) == 3:
        assert tout[2].shape == jout[2].shape
        np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), atol=1e-6)


def test_coverage_penalty_formula_matches_jax():
    rng = np.random.default_rng(1)
    cov = rng.uniform(0, 2, (3, 4, 7)).astype(np.float32)
    cov[rng.random(cov.shape) < 0.3] = 0.0  # masked source padding
    for beta in (0.3, -0.2):
        np.testing.assert_allclose(
            coverage_penalty(torch.from_numpy(cov), beta).numpy(),
            np.asarray(jbeam.coverage_penalty(jnp.asarray(cov), beta)), rtol=1e-6)
    one = torch.tensor([[[0.5, 2.0, 0.0, 1.0]]])  # tests/test_beam.py's case
    np.testing.assert_allclose(coverage_penalty(one, 0.3).numpy(), [[0.3 * np.log(0.5)]],
                               rtol=1e-6)


BEAMS = [
    dict(beam_size=1, max_len=6, coverage_penalty=0.5),
    dict(beam_size=3, max_len=8, coverage_penalty=0.4, length_penalty=0.6),
    dict(beam_size=4, max_len=6, n_best=3, coverage_penalty=0.3),
    dict(beam_size=3, max_len=6),
    dict(beam_size=4, max_len=6, n_best=3),
]


@pytest.mark.parametrize("return_attention", [False, True], ids=["tokens", "attention"])
@pytest.mark.parametrize("beam", BEAMS, ids=lambda b: "-".join(f"{k}{v}" for k, v in b.items()))
def test_dense_search_matches_jax(twin, beam, return_attention):
    jm, v, tm, _ = twin
    jout = jbeam.beam_search(jm, v, jnp.asarray(SRC), jnp.asarray(SRC_LEN), JaxBeamConfig(**beam),
                             return_attention=return_attention)
    tout = beam_search(tm, *_src(), BeamConfig(**beam), return_attention=return_attention,
                       device="cpu")
    assert_same(jout, tout)


@pytest.mark.parametrize("fused_topk", [True, False], ids=["candidates", "logits"])
@pytest.mark.parametrize("beam", BEAMS[1:3], ids=["beam3", "nbest3"])
def test_packed_coverage_and_attention_match_jax(twin, beam, fused_topk):
    jm, v, tm, params = twin
    jdec = jinfer.pack_decoder(v["params"], jm.cfg, 8, compute_dtype=jnp.float32,
                               use_pallas=False)
    tdec = pack_decoder(params, tm.cfg, 8, compute_dtype=torch.float32, device="cpu")
    for ra in (False, True):
        jout = jinfer.beam_search_packed(jm, v, jdec, jnp.asarray(SRC), jnp.asarray(SRC_LEN),
                                         JaxBeamConfig(**beam), fused_topk=fused_topk,
                                         return_attention=ra)
        tout = beam_search_packed(tm, tdec, *_src(), BeamConfig(**beam), fused_topk=fused_topk,
                                  return_attention=ra, device="cpu")
        assert_same(jout, tout)


def test_packed_decode_steps_return_align(twin):
    jm, v, tm, params = twin
    jdec = jinfer.pack_decoder(v["params"], jm.cfg, 8, compute_dtype=jnp.float32,
                               use_pallas=False)
    tdec = pack_decoder(params, tm.cfg, 8, compute_dtype=torch.float32, device="cpu")
    jk, jo, jmask, jst = jinfer.encode_packed(jm, v, jdec, jnp.asarray(SRC), jnp.asarray(SRC_LEN))
    from quantized_distillation_tpu_torch.serve import infer

    tk, to, tmask, tst = infer.encode_packed(tm, tdec, *_src())
    tok = [1, 7, 3]
    _, _, ja = jinfer.packed_decode_step(jdec, jst, jnp.asarray(tok, jnp.int32), jk, jo, jmask,
                                         with_align=True)
    _, tl, ta = infer.packed_decode_step(tdec, tst, torch.tensor(tok), tk, to, tmask,
                                         with_align=True)
    assert tl.shape == (3, 30)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    _, cand, ta2 = infer.packed_decode_step_topk(tdec, tst, torch.tensor(tok), tk, to, tmask, 3,
                                                 with_align=True)
    assert len(cand) == 3 and torch.equal(ta, ta2)
    assert len(infer.packed_decode_step(tdec, tst, torch.tensor(tok), tk, to, tmask)) == 2


def test_decode_step_attn_matches_jax(twin):
    jm, v, tm, _ = twin
    eo, em, st = jm.apply(v, jnp.asarray(SRC), jnp.asarray(SRC_LEN), method=jm.encode)
    teo, tem, tst = tm.encode(*_src())
    tok = np.array([1, 5, 9], np.int32)
    _, jl, ja = jm.apply(v, st, jnp.asarray(tok), eo, em, method=jm.decode_step_attn)
    _, tl, ta = tm.decode_step_attn(tst, torch.from_numpy(tok).long(), teo, tem)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    _, tl2 = tm.decode_step(tst, torch.from_numpy(tok).long(), teo, tem)
    assert torch.equal(tl, tl2)


def test_greedy_matches_jax(twin):
    jm, v, tm, _ = twin
    jt = jbeam.greedy_decode(jm, v, jnp.asarray(SRC), jnp.asarray(SRC_LEN), max_len=7)
    tt = greedy_decode(tm, *_src(), 7, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_greedy_score_shift_matches_manual_coverage(twin):
    """tests/test_beam.py's coverage check on the port: at beam 1 the
    penalized score is the raw score plus beta * sum(log(min(cov, 1))),
    with coverage accrued from the model's own attention while live."""
    _, _, tm, _ = twin
    beta, t_max = 0.5, 6
    src, sl = _src()
    t0, s0 = beam_search(tm, src, sl, BeamConfig(beam_size=1, max_len=t_max), device="cpu")
    t1, s1 = beam_search(tm, src, sl, BeamConfig(beam_size=1, max_len=t_max,
                                                 coverage_penalty=beta), device="cpu")
    assert torch.equal(t0, t1)
    enc_out, enc_mask, state = tm.encode(src, sl)
    cur = torch.full((3,), 1, dtype=torch.long)
    done = np.zeros(3, bool)
    cov = np.zeros((3, src.shape[1]))
    for _ in range(t_max):
        state, logits, align = tm.decode_step_attn(state, cur, enc_out, enc_mask)
        cov += np.where(done[:, None], 0.0, align.numpy())
        cur = logits.argmax(-1)
        done |= cur.numpy() == EOS
    want = beta * np.log(np.where(cov > 0, np.minimum(cov, 1.0), 1.0)).sum(1)
    np.testing.assert_allclose((s1 - s0).numpy(), want, rtol=1e-4, atol=1e-5)


def test_attention_rows_are_distributions(twin):
    """tests/test_beam.py's attention properties on the port: rows sum to 1
    on live steps and are zero past EOS; padding gets no mass; n-best rows
    pair with their hypotheses; tokens and scores unchanged by asking."""
    _, _, tm, _ = twin
    src, sl = _src()
    cfg = BeamConfig(beam_size=4, max_len=6, n_best=3)
    toks, scores, attn = beam_search(tm, src, sl, cfg, return_attention=True, device="cpu")
    t0, s0 = beam_search(tm, src, sl, cfg, device="cpu")
    assert torch.equal(toks, t0) and torch.equal(scores, s0)
    assert attn.shape == (3, 3, 6, 4)
    live = toks != PAD
    np.testing.assert_allclose(attn.sum(-1)[live].numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(attn[~live].numpy(), 0.0, atol=1e-7)
    for b in range(3):
        np.testing.assert_allclose(attn[b, :, :, int(sl[b]):].numpy(), 0.0, atol=1e-6)


def test_reconstruct_attention_matches_jax():
    rng = np.random.default_rng(3)
    t, b, k, ts = 7, 3, 4, 5
    attn = rng.random((t, b * k, ts)).astype(np.float32)
    par = rng.integers(0, k, (t, b * k)).astype(np.int8)
    want = jbeam.reconstruct_attention(jnp.asarray(attn), jnp.asarray(par), k)
    got = reconstruct_attention(torch.from_numpy(attn), torch.from_numpy(par), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [5, 6])
def test_unroll_ring_matches_jax(seed):
    """tests/test_beam.py's ring case (a window that wraps), and random
    windows: the unrolled histories and their backtrace equal JAX's."""
    rng = np.random.default_rng(seed)
    tp, e, k = 10, 4, 3
    sym = rng.integers(5, 50, (tp, e * k)).astype(np.int32)
    par = rng.integers(0, k, (tp, e * k)).astype(np.int8)
    start = np.asarray([7, 2, 0, 9], np.int32) if seed == 5 else rng.integers(0, tp, e)
    tlen = np.asarray([5, 4, 10, 0], np.int32) if seed == 5 else rng.integers(0, tp + 1, e)
    js, jp = jbeam.unroll_ring(jnp.asarray(sym), jnp.asarray(par), jnp.asarray(start, jnp.int32),
                               jnp.asarray(tlen, jnp.int32), beam_size=k)
    ts, tpar = unroll_ring(torch.from_numpy(sym), torch.from_numpy(par),
                           torch.from_numpy(np.asarray(start)), torch.from_numpy(np.asarray(tlen)),
                           beam_size=k)
    assert ts.dtype == torch.int32 and tpar.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tpar.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(reconstruct_tokens(ts, tpar, k).numpy(),
                                  np.asarray(jbeam.reconstruct_tokens(js, jp, k)))


def test_tokens_to_sentences_matches_jax():
    class Vocab:
        def decode(self, ids):
            return [f"w{i}" for i in ids]

    toks = np.array([[5, 6, EOS, 7], [EOS, 3, 3, 3], [4, 4, 4, 4]], np.int32)
    want = jbeam.tokens_to_sentences(toks, Vocab())
    assert tokens_to_sentences(torch.from_numpy(toks), Vocab()) == want
    assert tokens_to_sentences(toks, Vocab()) == want == [["w5", "w6"], [], ["w4"] * 4]


# ---------------------------------------------------------------- bidirectional


def test_bidirectional_encode_matches_jax(bi_twin):
    """Forward and backward LSTMs of hidden/2 a layer, the backward one over
    each sentence's own length: outputs and final carries equal JAX's."""
    jm, v, tm, _ = bi_twin
    eo, em, (jfin, jfeed) = jm.apply(v, jnp.asarray(SRC), jnp.asarray(SRC_LEN), method=jm.encode)
    teo, tem, (tfin, tfeed) = tm.encode(*_src())
    np.testing.assert_allclose(teo.numpy(), np.asarray(eo), atol=1e-6)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(em))
    assert len(tfin) == 2 and tfeed.shape == (3, 64)
    for (c, h), (jc, jh) in zip(tfin, jfin):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6)


def test_bidirectional_params_round_trip(bi_twin):
    """The flax tree names the cells OptimizedLSTMCell_{2i} (forward) and
    _{2i+1} (backward); the port reads and writes the same tree."""
    _, v, tm, _ = bi_twin
    jtree = jax.tree.map(np.asarray, v["params"])
    back = params_to_numpy(tm)
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("beam", [dict(beam_size=3, max_len=7),
                                  dict(beam_size=3, max_len=7, coverage_penalty=0.4)])
def test_bidirectional_beams_match_jax(bi_twin, beam):
    jm, v, tm, params = bi_twin
    assert_same(jbeam.beam_search(jm, v, jnp.asarray(SRC), jnp.asarray(SRC_LEN),
                                  JaxBeamConfig(**beam)),
                beam_search(tm, *_src(), BeamConfig(**beam), device="cpu"))
    jdec = jinfer.pack_decoder(v["params"], jm.cfg, 8, compute_dtype=jnp.float32,
                               use_pallas=False)
    tdec = pack_decoder(params, tm.cfg, 8, compute_dtype=torch.float32, device="cpu")
    assert_same(jinfer.beam_search_packed(jm, v, jdec, jnp.asarray(SRC), jnp.asarray(SRC_LEN),
                                          JaxBeamConfig(**beam)),
                beam_search_packed(tm, tdec, *_src(), BeamConfig(**beam), device="cpu"))


def test_bidirectional_train_logits_match_jax(bi_twin):
    jm, v, tm, _ = bi_twin
    tgt = np.array([[1, 5, 6], [1, 7, 0], [1, 2, 0]], np.int32)
    jl = jm.apply(v, jnp.asarray(SRC), jnp.asarray(SRC_LEN), jnp.asarray(tgt))
    tl = tm(*_src(), torch.from_numpy(tgt).long())
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5)
