"""The port's continuous-batching engine against the port's own offline
beam search (``tests/test_engine.py``'s properties, port vs port, on the
CPU through the plain versions): for any arrival pattern, admission batch,
chunk length, staging depth or ring wrap-around, every request decodes to
the offline search's tokens exactly, with its score within rtol 1e-5 (as
``tests/test_engine.py`` holds its coverage engine). Also the engine's
counters, its refusals, and its default device."""

import dataclasses

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import BeamConfig, ServeConfig
from quantized_distillation_tpu_torch.convert import params_to_numpy
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.serve import (
    TranslationEngine,
    beam_search,
    beam_search_packed,
    pack_decoder,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    m = make_seq2seq("student_small", 40, 50, hidden=64, embed_dim=32, dropout=0.0,
                     device="cpu", seed=3)
    rng = np.random.default_rng(0)
    sents = [list(rng.integers(4, 40, rng.integers(3, 9))) for _ in range(11)]
    src = torch.zeros((len(sents), 16), dtype=torch.int64)
    for i, s in enumerate(sents):
        src[i, : len(s)] = torch.tensor(s)
    sl = torch.tensor([len(s) for s in sents])
    dec = pack_decoder(params_to_numpy(m), m.cfg, 8, compute_dtype=torch.float32, device="cpu")
    return m, dec, sents, src, sl


def _offline(setup, beam: BeamConfig, packed=False, n=11):
    m, dec, _, src, sl = setup
    if packed:
        return beam_search_packed(m, dec, src[:n], sl[:n], beam, device="cpu")
    return beam_search(m, src[:n], sl[:n], beam, device="cpu")


def _cfg(slots, t_max=12, beam=None, **kw):
    beam = beam or BeamConfig(beam_size=3, max_len=t_max)
    return ServeConfig(max_slots=slots, max_src_len=16, max_tgt_len=t_max, beam=beam, **kw)


def _drive(eng, sents, arrival):
    res, rids, step = {}, {}, 0
    n = sum(len(x) for x in arrival.values())
    while len(res) < n:
        for i in arrival.get(step, []):
            rids[eng.submit(sents[i])] = i
        for c in eng.step():
            res[rids[c.request_id]] = c
        step += 1
        assert step < 400
    return res


def _check(res, toks, scores):
    for i, c in res.items():
        np.testing.assert_array_equal(c.tokens, toks[i].numpy(), err_msg=f"sentence {i}")
        np.testing.assert_allclose(c.score, float(scores[i]), rtol=1e-5)


ARRIVALS = {
    "upfront": {0: list(range(11))},
    "staggered": {0: [0, 1], 2: [2], 5: [3, 4, 5], 7: [6, 7, 8, 9, 10]},
    "bursts": {0: [0, 1], 1: [2, 3, 4, 5], 3: [6, 7, 8, 9, 10]},
    "burst_then_tail": {0: list(range(8)), 5: [8, 9, 10]},
}
ENGINES = [
    ("upfront", dict(slots=4)),
    ("staggered", dict(slots=3)),
    ("bursts", dict(slots=3, admit_batch=2, chunk_steps=4)),
    ("bursts", dict(slots=3, admit_batch=8, chunk_steps=3)),
    ("bursts", dict(slots=3, admit_batch=1, chunk_steps=1)),
    ("bursts", dict(slots=3, admit_batch=4, chunk_steps=4, chunk_steps_busy=1)),
    ("burst_then_tail", dict(slots=3, admit_batch=4, stage_ahead=1)),
    ("burst_then_tail", dict(slots=3, admit_batch=4, stage_ahead=2)),
    ("upfront", dict(slots=1)),  # the ring (12 + 64 rows) wraps
]


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("case", ENGINES, ids=lambda c: c[0] + "-" + "-".join(
    f"{k}{v}" for k, v in c[1].items()))
def test_engine_equals_offline(setup, case, packed):
    arrival, kw = case
    kw = dict(kw)
    toks, scores = _offline(setup, BeamConfig(beam_size=3, max_len=12), packed)
    eng = TranslationEngine(setup[0], _cfg(kw.pop("slots"), **kw),
                            setup[1] if packed else None, device="cpu")
    res = _drive(eng, setup[2], ARRIVALS[arrival])
    _check(res, toks, scores)
    if eng.cfg.max_slots == 1:
        assert eng.steps_run > eng._t_hist  # the ring wrapped


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_coverage_engine_equals_offline(setup, packed):
    beam = BeamConfig(beam_size=3, max_len=12, length_penalty=0.6, coverage_penalty=0.4)
    toks, scores = _offline(setup, beam, packed)
    eng = TranslationEngine(setup[0], _cfg(3, beam=beam, admit_batch=2, stage_ahead=1),
                            setup[1] if packed else None, device="cpu")
    _check(_drive(eng, setup[2], ARRIVALS["staggered"]), toks, scores)


def test_packed_logits_engine_equals_offline(setup):
    """beam 9 > KMAX: the packed logits path, with coverage."""
    beam = BeamConfig(beam_size=9, max_len=12, coverage_penalty=0.4)
    toks, scores = _offline(setup, beam, packed=True, n=6)
    eng = TranslationEngine(setup[0], _cfg(2, beam=beam), setup[1], device="cpu")
    _check(_drive(eng, setup[2], {0: list(range(6))}), toks, scores)


def test_n_best_completions(setup):
    beam = BeamConfig(beam_size=3, max_len=12, n_best=2)
    toks, scores = _offline(setup, beam)
    t1, _ = _offline(setup, BeamConfig(beam_size=3, max_len=12))
    eng = TranslationEngine(setup[0], _cfg(3, beam=beam), device="cpu")
    res = _drive(eng, setup[2], {0: [0, 1, 2, 3]})
    for i, c in res.items():
        assert c.nbest_tokens.shape == (2, 12) and c.nbest_scores[0] >= c.nbest_scores[1]
        np.testing.assert_array_equal(c.nbest_tokens, toks[i].numpy())
        np.testing.assert_allclose(c.nbest_scores, scores[i].numpy(), rtol=1e-5)
        np.testing.assert_array_equal(c.tokens, t1[i].numpy())


def test_large_t_max(setup):
    beam = BeamConfig(beam_size=3, max_len=192)
    toks, scores = _offline(setup, beam, n=5)
    eng = TranslationEngine(setup[0], _cfg(3, t_max=192, beam=beam), device="cpu")
    _check(_drive(eng, setup[2], {0: list(range(5))}), toks, scores)


def test_explicit_chunk_steps_and_counters(setup):
    toks, _ = _offline(setup, BeamConfig(beam_size=3, max_len=12))
    eng = TranslationEngine(setup[0], _cfg(2), device="cpu")
    eng.submit(setup[2][0])
    out = []
    for n in (1, 3, 2, 6):  # runtime chunk lengths
        out.extend(eng.step(chunk_steps=n))
    assert eng.steps_run == 12 and len(out) == 1
    np.testing.assert_array_equal(out[0].tokens, toks[0].numpy())
    eng = TranslationEngine(setup[0], _cfg(4), device="cpu")
    for s in setup[2][:4]:
        eng.submit(s)
    eng.run_until_drained()
    assert eng.steps_run == 12 and eng.tokens_emitted == 4 * 12  # lockstep to max_tgt_len


def test_empty_step_and_pending_counts(setup):
    eng = TranslationEngine(setup[0], _cfg(2, admit_batch=2, stage_ahead=2), device="cpu")
    assert eng.step() == [] and eng.steps_run == 0
    for s in setup[2][:7]:
        eng.submit(s)
    eng.step()  # admits 2, stages up to 4, leaves 1 queued
    assert (eng.active_slots, eng.pending) == (2, 5)
    assert len(eng.run_until_drained()) == 7


def test_drive_chunks_poisons_and_counts(setup):
    eng = TranslationEngine(setup[0], _cfg(4), device="cpu")
    for s in setup[2][:4]:
        eng.submit(s)
    eng.step()
    assert eng.drive_chunks(3) == 4 * eng.cfg.chunk_steps  # every slot, every step
    assert eng.drive_chunks(1, force_active=False) >= 0
    with pytest.raises(RuntimeError, match="force_active"):
        eng.step()


def test_refusals(setup):
    m, dec = setup[0], setup[1]
    eng = TranslationEngine(m, _cfg(2), device="cpu")
    eng.submit(setup[2][0])
    with pytest.raises(ValueError, match="headroom"):
        eng.step(chunk_steps=65)
    with pytest.raises(ValueError, match="headroom"):
        eng.drive_chunks(5, force_active=False, chunk_steps=16)
    # a generator that is one vocab shard of two serves only on a mesh
    with pytest.raises(ValueError, match="vocab shard"):
        TranslationEngine(m, _cfg(2), dataclasses.replace(dec, vocab_shard=(0, 2)), device="cpu")
    with pytest.raises(ValueError, match="n_best"):
        TranslationEngine(m, _cfg(2, beam=BeamConfig(beam_size=2, n_best=3)), device="cpu")


def test_engine_defaults_to_the_card(setup):
    from quantized_distillation_tpu_torch.serve import greedy_decode

    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        TranslationEngine(setup[0], _cfg(2))
    with pytest.raises(RuntimeError, match="cuda"):
        greedy_decode(setup[0], setup[3][:2], setup[4][:2], 4)
