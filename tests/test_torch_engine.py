"""The port's continuous-batching engine (``serve/engine.py``) against the
JAX package's, and the engine form of the beam-advance kernel.

On the CPU the same requests, with the same arrival pattern, go through
both packages' ``TranslationEngine`` on the same weights (the JAX tests'
small widths: ``student_small``, hidden 64, embed 32, V 40/50, the 11
seeded sentences of ``tests/test_engine.py``): the dense model, the packed
candidate path (fused generator + beam advance) and the packed logits path
(beam 9 > KMAX), all f32 with 8-bit packed weights, with and without the
coverage penalty. Tokens must be equal and scores within rtol 1e-5 (as
``tests/test_engine.py`` holds its coverage engine to the offline search),
and the step and token counters equal.

Tests marked ``gpu`` hold the advance kernel with a device ``pos`` and an
``active`` mask bit-exact against its plain version (also replayed in a
CUDA graph while ``pos`` advances), and the engine on the card against the
offline search on the card at f32. JAX is imported inside the CPU tests'
fixture, so ``pytest -m gpu`` runs on a machine without JAX.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import BeamConfig, ServeConfig
from quantized_distillation_tpu_torch.convert import params_from_numpy, params_to_numpy
from quantized_distillation_tpu_torch.kernels import (
    beam_advance,
    beam_advance_reference,
    launch_counts,
)
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig, make_seq2seq
from quantized_distillation_tpu_torch.serve import (
    TranslationEngine,
    beam_search,
    beam_search_packed,
    pack_decoder,
)
from quantized_distillation_tpu_torch.serve.beam import EOS, NEG_INF, PAD, init_beam_state
from quantized_distillation_tpu_torch.utils.graphs import CapturedStep

torch.set_num_threads(2)

STAGGER = {0: [0, 1], 2: [2], 5: [3, 4, 5], 7: [6, 7, 8, 9, 10]}
BURSTS = {0: [0, 1], 1: [2, 3, 4, 5], 3: [6, 7, 8, 9, 10]}
UPFRONT = {0: list(range(11))}


def _sentences():
    rng = np.random.default_rng(0)  # the sentences of tests/test_engine.py
    return [list(rng.integers(4, 40, rng.integers(3, 9))) for _ in range(11)]


@pytest.fixture(scope="module")
def twin():
    """The JAX model and its port on the same weights, both packages'
    8-bit f32 decoders, and the JAX package's engine and configs."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu import config as jconfig
    from quantized_distillation_tpu.models import make_seq2seq as jax_make_seq2seq
    from quantized_distillation_tpu.serve.engine import TranslationEngine as JaxEngine
    from quantized_distillation_tpu.serve.infer import pack_decoder as jax_pack_decoder

    jm = jax_make_seq2seq("student_small", 40, 50, hidden=64, embed_dim=32, dropout=0.0)
    sents = _sentences()
    src = np.zeros((len(sents), 16), np.int32)
    for i, s in enumerate(sents):
        src[i, : len(s)] = s
    slen = np.asarray([len(s) for s in sents], np.int32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(slen),
                jnp.ones((len(sents), 2), jnp.int32))
    params = params_from_numpy(jax.tree.map(np.asarray, v["params"]))
    tm = Seq2Seq(Seq2SeqConfig(**dataclasses.asdict(jm.cfg)), device="cpu").load_params(params)
    return types.SimpleNamespace(
        jm=jm, v=v, tm=tm, sents=sents, JaxEngine=JaxEngine, jconfig=jconfig,
        jdec=jax_pack_decoder(v["params"], jm.cfg, 8, compute_dtype=jnp.float32,
                              use_pallas=False),
        tdec=pack_decoder(params, tm.cfg, 8, compute_dtype=torch.float32, device="cpu"),
    )


def serve(eng, sents, arrival, chunk_steps=()):
    """Submit ``sents[i]`` at the step ``arrival`` gives it, step until all
    complete (``chunk_steps``: explicit chunk lengths for the first steps)
    → {sentence index: completion}."""
    res, rids, step = {}, {}, 0
    n = sum(len(x) for x in arrival.values())
    while len(res) < n:
        for i in arrival.get(step, []):
            rids[eng.submit(sents[i])] = i
        n_steps = chunk_steps[step] if step < len(chunk_steps) else None
        for c in eng.step(n_steps):
            res[rids[c.request_id]] = c
        step += 1
        assert step < 400
    return res


def _engines(tw, backend, serve_kw, beam_kw):
    """Both packages' engines for one configuration."""
    jc = tw.jconfig
    jcfg = jc.ServeConfig(beam=jc.BeamConfig(**beam_kw), **serve_kw)
    tcfg = ServeConfig(beam=BeamConfig(**beam_kw), **serve_kw)
    packed = backend != "dense"
    jeng = tw.JaxEngine(tw.jm, tw.v, jcfg, packed_decoder=tw.jdec if packed else None)
    teng = TranslationEngine(tw.tm, tcfg, packed_decoder=tw.tdec if packed else None,
                             device="cpu")
    return jeng, teng


def assert_same_completions(jres, tres):
    assert sorted(jres) == sorted(tres)
    for i, jc in jres.items():
        tc = tres[i]
        np.testing.assert_array_equal(tc.tokens, np.asarray(jc.tokens), err_msg=f"sentence {i}")
        np.testing.assert_allclose(tc.score, jc.score, rtol=1e-5, err_msg=f"sentence {i}")
        if jc.nbest_tokens is not None:
            np.testing.assert_array_equal(tc.nbest_tokens, np.asarray(jc.nbest_tokens))
            np.testing.assert_allclose(tc.nbest_scores, np.asarray(jc.nbest_scores), rtol=1e-5)
        else:
            assert tc.nbest_tokens is None


BASE = dict(max_src_len=16, max_tgt_len=12)
# (id, serve config, beam config, arrival pattern)
CASES = [
    ("upfront", dict(max_slots=4), {}, UPFRONT),
    ("staggered", dict(max_slots=3), {}, STAGGER),
    ("single_slot_ring_wraps", dict(max_slots=1), {}, UPFRONT),
    ("n_best", dict(max_slots=3), dict(n_best=2), {0: [0, 1, 2, 3]}),
    ("admit2_chunk4", dict(max_slots=3, admit_batch=2, chunk_steps=4), {}, BURSTS),
    ("admit8_chunk3", dict(max_slots=3, admit_batch=8, chunk_steps=3), {}, BURSTS),
    ("admit1_chunk1", dict(max_slots=3, admit_batch=1, chunk_steps=1), {}, BURSTS),
    ("adaptive", dict(max_slots=3, admit_batch=4, chunk_steps=4, chunk_steps_busy=1), {}, BURSTS),
    ("stage0", dict(max_slots=3, admit_batch=4), {}, {0: list(range(8)), 5: [8, 9, 10]}),
    ("stage1", dict(max_slots=3, admit_batch=4, stage_ahead=1), {},
     {0: list(range(8)), 5: [8, 9, 10]}),
    ("stage2", dict(max_slots=3, admit_batch=4, stage_ahead=2), {},
     {0: list(range(8)), 5: [8, 9, 10]}),
    ("coverage", dict(max_slots=3), dict(length_penalty=0.6, coverage_penalty=0.4),
     {0: [0, 1], 2: [2, 3, 4], 4: [5, 6, 7, 8, 9, 10]}),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_dense_engine_matches_jax(twin, case):
    _, serve_kw, beam_kw, arrival = case
    beam_kw = dict(dict(beam_size=3, max_len=12), **beam_kw)
    jeng, teng = _engines(twin, "dense", dict(BASE, **serve_kw), beam_kw)
    assert_same_completions(serve(jeng, twin.sents, arrival), serve(teng, twin.sents, arrival))
    assert (teng.steps_run, teng.tokens_emitted) == (jeng.steps_run, jeng.tokens_emitted)
    if teng.cfg.max_slots == 1:
        assert teng.steps_run > teng._t_hist  # the history ring wrapped


PACKED_CASES = [
    ("cand", 3, {}, dict(max_slots=4), UPFRONT),
    ("cand_coverage", 3, dict(coverage_penalty=0.4),
     dict(max_slots=3, admit_batch=4, chunk_steps=4, chunk_steps_busy=1, stage_ahead=1), BURSTS),
    ("cand_n_best", 4, dict(n_best=3, length_penalty=0.6), dict(max_slots=3), STAGGER),
    ("logits", 9, {}, dict(max_slots=3, admit_batch=2, chunk_steps=2), STAGGER),
    ("logits_coverage", 9, dict(length_penalty=0.6, coverage_penalty=0.4),
     dict(max_slots=2, stage_ahead=2), BURSTS),
]


@pytest.mark.parametrize("case", PACKED_CASES, ids=lambda c: c[0])
def test_packed_engine_matches_jax(twin, case):
    """The packed candidate path (beam <= KMAX: fused generator + beam
    advance) and the packed logits path (beam 9)."""
    _, beam, beam_kw, serve_kw, arrival = case
    beam_kw = dict(beam_size=beam, max_len=12, **beam_kw)
    jeng, teng = _engines(twin, "packed", dict(BASE, **serve_kw), beam_kw)
    assert_same_completions(serve(jeng, twin.sents, arrival), serve(teng, twin.sents, arrival))
    assert (teng.steps_run, teng.tokens_emitted) == (jeng.steps_run, jeng.tokens_emitted)


@pytest.mark.parametrize("backend", ["dense", "packed"])
def test_explicit_chunk_steps_match_jax(twin, backend):
    jeng, teng = _engines(twin, backend, dict(BASE, max_slots=2), dict(beam_size=3, max_len=12))
    arrival = {0: [0], 2: [1]}
    chunks = (1, 3, 2, 6)  # runtime chunk lengths, then the default
    assert_same_completions(serve(jeng, twin.sents, arrival, chunks),
                            serve(teng, twin.sents, arrival, chunks))
    assert teng.steps_run == jeng.steps_run


def test_large_t_max_matches_jax(twin):
    kw = dict(max_slots=3, max_src_len=16, max_tgt_len=192)
    jeng, teng = _engines(twin, "dense", kw, dict(beam_size=3, max_len=192))
    arrival = {0: [0, 1, 2, 3, 4]}
    assert_same_completions(serve(jeng, twin.sents, arrival), serve(teng, twin.sents, arrival))


@pytest.mark.parametrize("backend", ["dense", "packed"])
def test_drive_chunks_matches_jax(twin, backend):
    """The timing entry point: emitted counts of forced and live drives,
    and the engine's counters after them."""
    jeng, teng = _engines(twin, backend, dict(BASE, max_slots=4, chunk_steps=2),
                          dict(beam_size=3, max_len=12))
    for eng in (jeng, teng):
        for s in twin.sents[:3]:
            eng.submit(s)
        eng.step()
    assert teng.drive_chunks(1, force_active=False) == jeng.drive_chunks(1, force_active=False)
    assert teng.drive_chunks(3) == jeng.drive_chunks(3)
    assert teng.drive_chunks(2, chunk_steps=5) == jeng.drive_chunks(2, chunk_steps=5)
    assert teng.drive_chunks(1, force_active=False) == jeng.drive_chunks(1, force_active=False)
    assert teng.steps_run == jeng.steps_run
    with pytest.raises(RuntimeError, match="force_active"):
        teng.step()


@pytest.mark.parametrize("backend", ["dense", "packed"])
def test_empty_step_is_a_noop_like_jax(twin, backend):
    jeng, teng = _engines(twin, backend, dict(BASE, max_slots=2), dict(beam_size=3, max_len=12))
    assert teng.step() == jeng.step() == []
    assert teng.steps_run == jeng.steps_run == 0 and teng.tokens_emitted == 0


def test_staged_pending_counts_match_jax(twin):
    kw = dict(BASE, max_slots=2, admit_batch=2, stage_ahead=2)
    jeng, teng = _engines(twin, "dense", kw, dict(beam_size=3, max_len=12))
    for eng in (jeng, teng):
        for s in twin.sents[:7]:
            eng.submit(s)
        eng.step()  # admits 2, stages up to 4, leaves 1 queued
    assert (teng.active_slots, teng.pending) == (jeng.active_slots, jeng.pending) == (2, 5)
    jres = {c.request_id: c for c in jeng.run_until_drained()}
    tres = {c.request_id: c for c in teng.run_until_drained()}
    assert len(tres) == 7
    assert_same_completions(jres, tres)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _advance_inputs(rng, b, k, kc, t_max, dev):
    """A step's candidates (coarse values: exact ties; EOS winners; NEG_INF
    blocks) and a beam state (a third of the beams finished)."""
    vals = -np.sort(rng.integers(0, 6, (b * k, kc)) * 0.5, axis=1).astype(np.float32)
    vals[rng.random(b * k) < 0.15] = NEG_INF
    idx = rng.integers(4, 600, (b * k, kc)).astype(np.int32)
    idx[rng.random((b * k, kc)) < 0.2] = EOS
    lse = rng.uniform(0.5, 2.0, (b * k, 1)).astype(np.float32)
    s = init_beam_state(torch.zeros(b * k, 1), b, k, t_max, device="cpu")
    s.scores.copy_(torch.from_numpy(rng.integers(-8, 0, (b, k)).astype(np.float32)))
    s.finished.copy_(torch.from_numpy(rng.random((b, k)) < 0.3))
    s.lengths.copy_(torch.from_numpy(rng.integers(0, 5, (b, k)).astype(np.int32)))
    s.last_token.copy_(torch.from_numpy(rng.integers(0, 600, (b, k))))
    s.sym.copy_(torch.from_numpy(rng.integers(0, 600, s.sym.shape).astype(np.int32)))
    cand = tuple(torch.from_numpy(a).to(dev) for a in (vals, idx, lse))
    state = (s.scores, s.finished, s.lengths, s.last_token, s.sym, s.parent)
    return cand, [x.to(dev) for x in state]


ENGINE_FORM_CASES = [  # (B, K, kc, pos, share of sentences active)
    (256, 5, 5, 0, 0.5), (256, 5, 5, 87, 0.5), (256, 5, 5, 87, 0.0), (256, 5, 5, 0, 1.0),
    (37, 1, 3, 5, 0.6), (37, 3, 5, 0, 0.6), (37, 8, 8, 87, 0.6), (37, 5, 8, 87, 0.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ENGINE_FORM_CASES,
                         ids=lambda c: "B{}-K{}-kc{}-pos{}-active{}".format(*c))
def test_gpu_beam_advance_engine_form_bit_exact(cuda, case):
    """``pos`` on the device (the first and the last ring row) and an
    ``active`` mask (some, none, all): the kernel equals its plain version
    in every output, and inactive sentences keep their state."""
    b, k, kc, pos, share = case
    t_max = 88
    rng = np.random.default_rng(b + 10 * k + kc + pos)
    cand, state = _advance_inputs(rng, b, k, kc, t_max, cuda)
    active = torch.from_numpy(rng.random(b) < share).to(cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    got, want, before = ([x.clone() for x in state] for _ in range(3))
    n0 = beam_advance.launches
    rows = beam_advance(*cand, *got, eos_id=EOS, pad_id=PAD, pos=p, active=active)
    torch.cuda.synchronize()
    assert beam_advance.launches == n0 + 1
    ref = beam_advance_reference(*cand, *want, eos_id=EOS, pad_id=PAD, pos=p, active=active)
    assert torch.equal(rows, ref)
    for name, x, y in zip(("scores", "finished", "lengths", "last_token", "sym", "parent"),
                          got, want):
        assert torch.equal(x, y), name
    idle = ~active
    ident = torch.arange(b * k, device=cuda).reshape(b, k)
    assert torch.equal(rows.reshape(b, k)[idle], ident[idle])
    for x, x0 in zip(got[:4], before[:4]):
        assert torch.equal(x[idle], x0[idle])
    # rows other than pos are untouched
    other = torch.arange(t_max, device=cuda) != pos
    assert torch.equal(got[4][other], before[4][other])


@pytest.mark.gpu
def test_gpu_beam_advance_replayed_at_changing_pos(cuda):
    """The advance with ``pos`` captured in a CUDA graph that also advances
    ``pos`` (as the engine's step does), replayed with new candidates each
    time: equal to the plain version stepped eagerly at the same rows."""
    b, k, kc, t_max = 64, 5, 5, 7
    rng = np.random.default_rng(11)
    cand, state = _advance_inputs(rng, b, k, kc, t_max, cuda)
    active = torch.from_numpy(rng.random(b) < 0.7).to(cuda)
    want = [x.clone() for x in state]
    pos = torch.tensor([t_max - 2], dtype=torch.int32, device=cuda)
    rows = torch.zeros(b * k, dtype=torch.int64, device=cuda)

    def step():
        rows.copy_(beam_advance(*cand, *state, eos_id=EOS, pad_id=PAD, pos=pos, active=active))
        pos.add_(1).remainder_(t_max)

    snapshot = [x.clone() for x in state]
    graph = CapturedStep(step)  # its warm-up steps once: start again from the snapshot
    for x, x0 in zip(state, snapshot):
        x.copy_(x0)
    pos.fill_(t_max - 2)
    n0 = launch_counts()["beam_advance"]
    for i in range(4):  # rows 5, 6, 0, 1
        new, _ = _advance_inputs(rng, b, k, kc, t_max, cuda)
        for c, n in zip(cand, new):
            c.copy_(n)
        graph.replay()
        p = torch.tensor([(t_max - 2 + i) % t_max], dtype=torch.int32, device=cuda)
        ref = beam_advance_reference(*cand, *want, eos_id=EOS, pad_id=PAD, pos=p, active=active)
        torch.cuda.synchronize()
        assert torch.equal(rows, ref), f"replay {i}"
        for x, y in zip(state, want):
            assert torch.equal(x, y), f"replay {i}"
    assert launch_counts()["beam_advance"] == n0 + 4


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    m = make_seq2seq("student_small", 40, 600, hidden=64, embed_dim=32, num_layers=2,
                     device="cuda", seed=5)
    dec = pack_decoder(params_to_numpy(m), m.cfg, 4, compute_dtype=torch.float32,
                       generator_group=2, device="cuda")
    return m, dec


def _offline(m, dec, sents, beam_kw):
    src = torch.zeros((len(sents), 16), dtype=torch.int64)
    for i, s in enumerate(sents):
        src[i, : len(s)] = torch.tensor(s)
    sl = torch.tensor([len(s) for s in sents])
    cfg = BeamConfig(**beam_kw)
    if dec is None:
        return beam_search(m, src, sl, cfg)
    return beam_search_packed(m, dec, src, sl, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["packed", "dense"])
@pytest.mark.parametrize("coverage", [0.0, 0.4])
def test_gpu_engine_matches_offline_search(card_model, backend, coverage):
    """f32 on the card: the engine's tokens equal the offline search's and
    its scores are within rtol 1e-5, staggered arrivals; a packed chunk of
    n steps launches 3n dequant-matmuls, n fused top-k and n advances."""
    m, dec = card_model
    dec = dec if backend == "packed" else None
    sents = _sentences()
    beam_kw = dict(beam_size=3, max_len=12, length_penalty=0.6, coverage_penalty=coverage)
    toks, scores = _offline(m, dec, sents, beam_kw)
    cfg = ServeConfig(max_slots=3, max_src_len=16, max_tgt_len=12, admit_batch=2,
                      chunk_steps=3, beam=BeamConfig(**beam_kw))
    eng = TranslationEngine(m, cfg, packed_decoder=dec)
    res = serve(eng, sents, STAGGER)
    for i, c in res.items():
        np.testing.assert_array_equal(c.tokens, toks[i].cpu().numpy(), err_msg=f"sentence {i}")
        np.testing.assert_allclose(c.score, float(scores[i]), rtol=1e-5)
    if dec is not None:
        for s in sents[:3]:
            eng.submit(s)
        eng.step(1)  # admit
        before = launch_counts()
        eng.drive_chunks(2, chunk_steps=4)
        after = launch_counts()
        grew = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        assert grew == {"dequant_matmul": 24, "dequant_matmul_topk": 8, "beam_advance": 8}
