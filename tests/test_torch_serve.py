"""The PyTorch port's serving path against the JAX package's, on the same
weights: dense and packed beam search return the same tokens at f32 (the
port through its plain kernel versions on the CPU, JAX through its jnp
reference path), scores within 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_distillation_tpu.config import BeamConfig as JaxBeamConfig
from quantized_distillation_tpu.models import make_seq2seq as jax_make_seq2seq
from quantized_distillation_tpu.serve import beam_search as jax_beam_search
from quantized_distillation_tpu.serve import infer as jinfer
from quantized_distillation_tpu_torch.config import BeamConfig
from quantized_distillation_tpu_torch.convert import params_from_numpy
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig
from quantized_distillation_tpu_torch.serve import beam_search, infer

torch.set_num_threads(2)

GEN_GROUP = 2  # pads the 600-word vocab to 1024 columns in both packages


@pytest.fixture(scope="module")
def twin():
    jm = jax_make_seq2seq(
        "student_small", 50, 600, hidden=64, embed_dim=32, dropout=0.0, num_layers=2,
    )
    src = np.array([[5, 6, 7, 8, 9, 10], [9, 10, 11, 12, 0, 0], [4, 40, 0, 0, 0, 0]], np.int32)
    sl = np.array([6, 4, 2], np.int32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(sl), jnp.ones((3, 2), jnp.int32))
    tree = jax.tree.map(np.asarray, v["params"])
    params = params_from_numpy(tree)
    tm = Seq2Seq(Seq2SeqConfig(**dataclasses.asdict(jm.cfg)), device="cpu").load_params(params)
    return jm, v, tm, params, src, sl


def _decoders(twin, bits, cd=torch.float32):
    jm, v, tm, params, _, _ = twin
    jcd = jnp.float32 if cd == torch.float32 else jnp.bfloat16
    jdec = jinfer.pack_decoder(
        v["params"], jm.cfg, bits, compute_dtype=jcd, use_pallas=False,
        generator_group=GEN_GROUP,
    )
    tdec = infer.pack_decoder(
        params, tm.cfg, bits, compute_dtype=cd, generator_group=GEN_GROUP, device="cpu"
    )
    return jdec, tdec


def _assert_same_beams(jout, tout):
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-4)


BEAMS = [
    dict(beam_size=3, max_len=8),
    dict(beam_size=4, max_len=7, n_best=2),
    dict(beam_size=3, max_len=9, length_penalty=0.6),
]


@pytest.mark.parametrize("beam", BEAMS)
def test_dense_beam_search_matches_jax(twin, beam):
    jm, v, tm, _, src, sl = twin
    jout = jax_beam_search(jm, v, jnp.asarray(src), jnp.asarray(sl), JaxBeamConfig(**beam))
    tout = beam_search(tm, torch.from_numpy(src).long(), torch.from_numpy(sl), BeamConfig(**beam), device="cpu")
    _assert_same_beams(jout, tout)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("beam", BEAMS)
def test_packed_beam_search_matches_jax(twin, bits, beam):
    jm, v, tm, _, src, sl = twin
    jdec, tdec = _decoders(twin, bits)
    jout = jinfer.beam_search_packed(jm, v, jdec, jnp.asarray(src), jnp.asarray(sl), JaxBeamConfig(**beam))
    tout = infer.beam_search_packed(
        tm, tdec, torch.from_numpy(src).long(), torch.from_numpy(sl), BeamConfig(**beam), device="cpu"
    )
    _assert_same_beams(jout, tout)


def _codebook_decoders(twin, lut_mode, bits=4):
    """Both packages' decoders packed with one learned-looking codebook."""
    jm, v, tm, params, _, _ = twin
    pts = np.random.default_rng(bits).uniform(-0.05, 1.05, 1 << bits).astype(np.float32)
    jdec = jinfer.pack_decoder(
        v["params"], jm.cfg, bits, points=jnp.asarray(pts), lut_mode=lut_mode,
        compute_dtype=jnp.float32, use_pallas=False, generator_group=GEN_GROUP,
    )
    tdec = infer.pack_decoder(
        params, tm.cfg, bits, points=torch.from_numpy(pts), lut_mode=lut_mode,
        compute_dtype=torch.float32, generator_group=GEN_GROUP, device="cpu",
    )
    return jdec, tdec


@pytest.mark.parametrize("lut_mode", ["exact", "requant8"])
@pytest.mark.parametrize("beam", BEAMS[:2])
def test_codebook_beam_search_matches_jax(twin, lut_mode, beam):
    jm, v, tm, _, src, sl = twin
    jdec, tdec = _codebook_decoders(twin, lut_mode)
    if lut_mode == "exact":  # every matrix keeps its indices and the LUT
        assert all(p.points is not None for p in (tdec.generator, tdec.attn_out, tdec.cells[0].w))
        assert tdec.generator.shape == (64, 600) and tdec.generator.bias.shape == (600,)
    else:
        assert tdec.generator.points is None and tdec.generator.bits == 8
    jout = jinfer.beam_search_packed(jm, v, jdec, jnp.asarray(src), jnp.asarray(sl), JaxBeamConfig(**beam))
    tout = infer.beam_search_packed(
        tm, tdec, torch.from_numpy(src).long(), torch.from_numpy(sl), BeamConfig(**beam), device="cpu"
    )
    _assert_same_beams(jout, tout)


def test_codebook_requant8_decodes_like_exact(twin):
    # tests/test_infer.py::test_codebook_requant8_matches_exact, on the port
    _, _, tm, _, src, sl = twin
    cfg = BeamConfig(beam_size=2, max_len=6)
    s, sl_t = torch.from_numpy(src).long(), torch.from_numpy(sl)
    _, d_exact = _codebook_decoders(twin, "exact")
    _, d_rq = _codebook_decoders(twin, "requant8")
    t1, _ = infer.beam_search_packed(tm, d_exact, s, sl_t, cfg, device="cpu")
    t2, _ = infer.beam_search_packed(tm, d_rq, s, sl_t, cfg, device="cpu")
    assert torch.equal(t1, t2)
    # the logits path (no fused top-k) decodes the LUT deploy the same way
    t3, _ = infer.beam_search_packed(tm, d_exact, s, sl_t, cfg, fused_topk=False, device="cpu")
    assert torch.equal(t1, t3)


def test_logits_beam_path_matches_jax(twin):
    jm, v, tm, _, src, sl = twin
    jdec, tdec = _decoders(twin, 4)
    beam = dict(beam_size=3, max_len=8)
    jout = jinfer.beam_search_packed(
        jm, v, jdec, jnp.asarray(src), jnp.asarray(sl), JaxBeamConfig(**beam), fused_topk=False
    )
    tout = infer.beam_search_packed(
        tm, tdec, torch.from_numpy(src).long(), torch.from_numpy(sl), BeamConfig(**beam),
        fused_topk=False, device="cpu",
    )
    _assert_same_beams(jout, tout)


def test_packed_decode_step_matches_jax(twin):
    jm, v, tm, _, src, sl = twin
    jdec, tdec = _decoders(twin, 8)
    jk, jo, jmask, jst = jinfer.encode_packed(jm, v, jdec, jnp.asarray(src), jnp.asarray(sl))
    tk, to, tmask, tst = infer.encode_packed(tm, tdec, torch.from_numpy(src).long(), torch.from_numpy(sl))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    for tok in ([1, 1, 1], [7, 3, 59]):
        jst, jl = jinfer.packed_decode_step(jdec, jst, jnp.asarray(tok, jnp.int32), jk, jo, jmask)
        tst, tl = infer.packed_decode_step(tdec, tst, torch.tensor(tok), tk, to, tmask)
        assert tl.shape == (3, 600)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(tst.c.numpy(), np.asarray(jst.c), atol=1e-5)


def test_bf16_step_topk_values_within_tolerance(twin):
    """bf16 rounds at other places in the two frameworks: one step's top-k
    values agree within 2e-2 relative to the row's largest |logit|."""
    jm, v, tm, _, src, sl = twin
    jdec, tdec = _decoders(twin, 4, torch.bfloat16)
    jk, jo, jmask, jst = jinfer.encode_packed(jm, v, jdec, jnp.asarray(src), jnp.asarray(sl))
    tk, to, tmask, tst = infer.encode_packed(tm, tdec, torch.from_numpy(src).long(), torch.from_numpy(sl))
    tok = [1, 1, 1]
    _, (jv, _, jlse) = jinfer.packed_decode_step_topk(jdec, jst, jnp.asarray(tok, jnp.int32), jk, jo, jmask, 5)
    _, (tv, _, tlse) = infer.packed_decode_step_topk(tdec, tst, torch.tensor(tok), tk, to, tmask, 5)
    scale = np.abs(np.asarray(jv)).max(axis=1, keepdims=True)
    assert np.all(np.abs(tv.numpy() - np.asarray(jv)) <= 2e-2 * scale)
    assert np.all(np.abs(tlse.numpy() - np.asarray(jlse)) <= 2e-2 * scale)


def test_fuse_unfuse_round_trip(twin):
    _, _, tm, _, src, sl = twin
    _, tdec = _decoders(twin, 4, torch.bfloat16)
    *_, nested = infer.encode_packed(tm, tdec, torch.from_numpy(src).long(), torch.from_numpy(sl), fused=False)
    fused = infer.fuse_dec_state(nested, torch.bfloat16)
    assert fused.c.dtype == torch.float32 and fused.hf.dtype == torch.bfloat16
    back = infer.unfuse_dec_state(fused, 2, 64)
    for (c0, h0), (c1, h1) in zip(nested[0], back[0]):
        assert torch.equal(c0, c1) and torch.equal(h0, h1)
    assert torch.equal(nested[1], back[1])


def test_fused_step_equals_nested_step(twin):
    _, _, tm, _, src, sl = twin
    _, tdec = _decoders(twin, 4)
    s, sl_t = torch.from_numpy(src).long(), torch.from_numpy(sl)
    k, o, m, fused = infer.encode_packed(tm, tdec, s, sl_t)
    *_, nested = infer.encode_packed(tm, tdec, s, sl_t, fused=False)
    tok = torch.tensor([1, 4, 9])
    fs, fl = infer.packed_decode_step(tdec, fused, tok, k, o, m)
    ns, nl = infer.packed_decode_step(tdec, nested, tok, k, o, m)
    assert torch.equal(fl, nl)
    assert torch.equal(infer.fuse_dec_state(ns, torch.float32).hf, fs.hf)


def test_unported_options_raise(twin):
    # the coverage penalty, return_attention and the engine's multi-device
    # form are ported; a vocab-sharded decoder serves only on a mesh
    from quantized_distillation_tpu_torch.config import ServeConfig
    from quantized_distillation_tpu_torch.serve import TranslationEngine

    _, _, tm, _, src, sl = twin
    _, tdec = _decoders(twin, 4)
    s, sl_t = torch.from_numpy(src).long(), torch.from_numpy(sl)
    cfg = BeamConfig(beam_size=3, max_len=5, coverage_penalty=0.2)
    toks, scores = infer.beam_search_packed(tm, tdec, s, sl_t, cfg, device="cpu")
    assert toks.shape == (3, 5) and torch.isfinite(scores).all()
    *_, attn = infer.beam_search_packed(tm, tdec, s, sl_t, cfg, return_attention=True, device="cpu")
    assert attn.shape == (3, 5, 6)
    shard = dataclasses.replace(tdec, vocab_shard=(1, 2))
    with pytest.raises(ValueError, match="vocab shard"):
        TranslationEngine(tm, ServeConfig(), shard, device="cpu")
    with pytest.raises(ValueError, match="vocab shard"):
        infer.beam_search_packed(tm, shard, s, sl_t, cfg, device="cpu")
