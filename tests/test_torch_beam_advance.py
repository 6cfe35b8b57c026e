"""The port's one-launch beam advance (``kernels/beam_combine.py::beam_advance``)
and its searches run as CUDA graphs.

On the CPU the advance's plain version, driven through the port's
``step_beams_cand``, is held to the JAX package's ``step_beams_cand``
(combine through the Pallas kernel in interpret mode and through
``lax.top_k``) over consecutive steps fed the same seeded candidates: the
scores, histories, flags, lengths, last tokens and reordered decoder state
exactly equal (the same two f32 roundings, the same tie order).

Tests marked ``gpu`` hold the CUDA kernel bit-exact against its plain
version, and the graphed searches bit-exact against the eager loop on the
card, with the launch counters counting replays. JAX is imported inside
the CPU tests' fixture, so ``pytest -m gpu`` runs on a machine without JAX.
"""

import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import BeamConfig
from quantized_distillation_tpu_torch.convert import params_to_numpy
from quantized_distillation_tpu_torch.kernels import (
    LAUNCH_COUNTERS,
    beam_advance,
    beam_advance_reference,
    launch_counts,
    set_launch_counts,
)
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.serve import beam_search, beam_search_packed, pack_decoder
from quantized_distillation_tpu_torch.serve.beam import (
    EOS,
    NEG_INF,
    PAD,
    SEARCH_GRAPHS,
    init_beam_state,
    step_beams_cand,
)
from quantized_distillation_tpu_torch.utils.graphs import signature

torch.set_num_threads(2)

# (K beams, kc candidates a beam): K in {1, 3, 5, 8}, kc = K and kc > K
SHAPES = [(1, 1), (1, 3), (3, 3), (3, 5), (5, 5), (5, 8), (8, 8)]
T_MAX = 6
STEPS = (0, 1, 2, T_MAX - 1)  # the first and the last history row


def _candidates(rng, b, k, kc):
    """One step's generator output for b sentences x k beams: values on a
    coarse grid (exact ties within and across beams; some sentences share
    one lse across their beams, so whole blocks tie), EOS among the winners,
    and NEG_INF blocks."""
    vals = -np.sort(rng.integers(0, 6, (b * k, kc)) * 0.5, axis=1).astype(np.float32)
    vals[rng.random(b * k) < 0.15] = NEG_INF
    idx = rng.integers(4, 600, (b * k, kc)).astype(np.int32)
    idx[rng.random((b * k, kc)) < 0.2] = EOS
    lse = rng.uniform(0.5, 2.0, (b * k, 1)).astype(np.float32)
    shared = np.repeat(rng.random(b) < 0.5, k)
    lse[shared] = 1.25
    return vals, idx, lse


# ---------------------------------------------------------------- on the CPU


def _state_args(s):
    """A beam state's tensors in ``beam_advance``'s argument order."""
    return s.scores, s.finished, s.lengths, s.last_token, s.sym, s.parent


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.serve import beam as jbeam

    return types.SimpleNamespace(jax=jax, jnp=jnp, beam=jbeam)


@pytest.mark.parametrize("combine", ["interpret", "xla"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"K{s[0]}-kc{s[1]}")
def test_step_beams_cand_matches_jax(jx, shape, combine):
    k, kc = shape
    b = 6
    rng = np.random.default_rng(10 * k + kc)
    dec0 = np.arange(b * k * 2, dtype=np.float32).reshape(b * k, 2)  # row ids
    jstate = jx.beam.init_beam_state(jx.jnp.asarray(dec0), b, k, T_MAX)
    tstate = init_beam_state(torch.from_numpy(dec0), b, k, T_MAX, device="cpu")
    for t in STEPS:
        vals, idx, lse = _candidates(rng, b, k, kc)

        def jcand(s, tokens):
            return s, (jx.jnp.asarray(vals), jx.jnp.asarray(idx), jx.jnp.asarray(lse))

        def tcand(s, tokens):
            return s, (torch.from_numpy(vals), torch.from_numpy(idx), torch.from_numpy(lse))

        jstate = jx.beam.step_beams_cand(jcand, jstate, jx.jnp.int32(t), beam_size=k,
                                         combine=combine)
        tstate = step_beams_cand(tcand, tstate, t, beam_size=k)
        for name in ("scores", "sym", "parent", "finished", "lengths", "last_token",
                     "decoder_state"):
            np.testing.assert_array_equal(
                getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
                err_msg=f"{name} after step {t}")
    # finished beams were exercised: some emitted PAD at the last step
    assert tstate.finished.any() and (tstate.sym[T_MAX - 1] == PAD).any()


def test_beam_advance_on_cpu_is_its_plain_version():
    """The wrapper on CPU tensors is its plain version, updating in place
    and returning the flat parent rows."""
    rng = np.random.default_rng(5)
    b, k, kc = 4, 3, 4
    vals, idx, lse = (torch.from_numpy(a) for a in _candidates(rng, b, k, kc))
    states = [init_beam_state(torch.zeros(b * k, 1), b, k, 3, device="cpu") for _ in range(2)]
    rows = [
        fn(vals, idx, lse, *_state_args(s), 1, eos_id=EOS, pad_id=PAD)
        for fn, s in zip((beam_advance, beam_advance_reference), states)
    ]
    assert torch.equal(rows[0], rows[1]) and rows[0].dtype == torch.int64
    assert bool(((rows[0] >= 0) & (rows[0] < b * k)).all())
    for a, c in zip(_state_args(states[0]), _state_args(states[1])):
        assert torch.equal(a, c)
    assert not torch.equal(states[0].sym[1], torch.full((b * k,), PAD, dtype=torch.int32))


def test_beam_advance_rejects_bad_operands():
    b, k, kc = 2, 3, 3
    s = init_beam_state(torch.zeros(b * k, 1), b, k, 4, device="cpu")
    vals, idx, lse = torch.zeros(b * k, kc), torch.zeros(b * k, kc, dtype=torch.int32), torch.zeros(b * k, 1)
    args = _state_args(s)
    with pytest.raises(ValueError, match="outside"):
        beam_advance(vals, idx, lse, *args, 4, eos_id=EOS, pad_id=PAD)
    with pytest.raises(ValueError, match="do not match"):
        beam_advance(vals[:-1], idx, lse, *args, 0, eos_id=EOS, pad_id=PAD)
    with pytest.raises(ValueError, match="histories"):
        beam_advance(vals, idx, lse, *args[:4], s.sym[:, :-1], s.parent, 0, eos_id=EOS, pad_id=PAD)


def test_launch_counter_registry_round_trips():
    before = launch_counts()
    assert set(before) == set(LAUNCH_COUNTERS) and "beam_advance" in before
    try:
        set_launch_counts({"beam_advance": before["beam_advance"] + 24})
        assert beam_advance.launches == before["beam_advance"] + 24
    finally:
        set_launch_counts(before)
    assert launch_counts() == before


def test_signature_follows_tensor_addresses_and_values():
    m = make_seq2seq("student_small", 20, 30, hidden=16, embed_dim=8, device="cpu")
    dec = pack_decoder(params_to_numpy(m), m.cfg, 4, device="cpu")
    assert signature(dec) == signature(dec) and hash(signature(m))
    before = signature(dec)
    dec.tgt_embed = dec.tgt_embed.clone()  # same values, a new address
    assert signature(dec) != before
    assert signature(BeamConfig(beam_size=2)) != signature(BeamConfig(beam_size=3))
    with pytest.raises(TypeError):
        signature({"unhashable": 1})


def test_cpu_search_stays_eager():
    m = make_seq2seq("student_small", 20, 30, hidden=16, embed_dim=8, device="cpu")
    dec = pack_decoder(params_to_numpy(m), m.cfg, 4, device="cpu")
    src, sl = torch.ones(2, 3, dtype=torch.long), torch.tensor([3, 2])
    n0 = SEARCH_GRAPHS.captures
    cfg = BeamConfig(beam_size=2, max_len=3)
    a = beam_search_packed(m, dec, src, sl, cfg, device="cpu")
    b = beam_search_packed(m, dec, src, sl, cfg, device="cpu", _eager=True)
    c = beam_search(m, src, sl, cfg, device="cpu")
    assert SEARCH_GRAPHS.captures == n0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and c[0].shape == (2, 3)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _state_pair(cuda, b, k, t_max, rng):
    """Two equal beam states on the card, some beams finished, lengths and
    histories made up."""
    s = init_beam_state(torch.zeros(b * k, 1), b, k, t_max, device="cpu")
    s.scores.copy_(torch.from_numpy(rng.integers(-8, 0, (b, k)).astype(np.float32)))
    s.finished.copy_(torch.from_numpy(rng.random((b, k)) < 0.3))
    s.lengths.copy_(torch.from_numpy(rng.integers(0, 5, (b, k)).astype(np.int32)))
    s.sym.copy_(torch.from_numpy(rng.integers(0, 600, s.sym.shape).astype(np.int32)))
    return [type(s)(*(x if x is None else x.to(cuda).clone() for x in s)) for _ in range(2)]


ADVANCE_CASES = [(256, 5, 5, 0), (256, 5, 5, 23)] + [(37, k, kc, t) for k, kc in SHAPES
                                                    for t in (0, T_MAX - 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ADVANCE_CASES, ids=lambda c: "B{}-K{}-kc{}-t{}".format(*c))
def test_gpu_beam_advance_bit_exact(cuda, case):
    b, k, kc, t = case
    rng = np.random.default_rng(b + 10 * k + kc + t)
    t_max = max(t + 1, T_MAX)
    vals, idx, lse = (torch.from_numpy(a).to(cuda) for a in _candidates(rng, b, k, kc))
    got, want = _state_pair(cuda, b, k, t_max, rng)
    n0 = beam_advance.launches
    rows = beam_advance(vals, idx, lse, *_state_args(got), t, eos_id=EOS, pad_id=PAD)
    torch.cuda.synchronize()
    assert beam_advance.launches == n0 + 1
    ref = beam_advance_reference(vals, idx, lse, *_state_args(want), t, eos_id=EOS,
                                 pad_id=PAD)
    assert torch.equal(rows, ref)
    for name in ("sym", "parent", "last_token", "scores", "finished", "lengths"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.gpu
def test_gpu_beam_advance_rejects_wide_rows(cuda):
    b, k, kc = 2, 8, 9
    s = _state_pair(cuda, b, k, 2, np.random.default_rng(0))[0]
    vals = torch.zeros(b * k, kc, device=cuda)
    with pytest.raises(ValueError, match="K \\* kc"):
        beam_advance(vals, vals.int(), vals[:, :1], *_state_args(s), 0, eos_id=EOS, pad_id=PAD)


@pytest.fixture(scope="module")
def served():
    """A small model on the card and its uniform and exact-LUT decoders at
    f32 and bf16 compute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    m = make_seq2seq("student_small", 50, 600, hidden=64, embed_dim=32, num_layers=2,
                     device="cuda", seed=3)
    params = params_to_numpy(m)
    pts = np.random.default_rng(4).uniform(-0.05, 1.05, 16).astype(np.float32)
    decs = {}
    for cd in (torch.float32, torch.bfloat16):
        decs["uniform", cd] = pack_decoder(params, m.cfg, 4, compute_dtype=cd,
                                           generator_group=2, device="cuda")
        decs["lut", cd] = pack_decoder(params, m.cfg, 4, points=pts, lut_mode="exact",
                                       compute_dtype=cd, generator_group=2, device="cuda")
    gen = torch.Generator().manual_seed(7)
    src = torch.randint(4, 50, (6, 7), generator=gen)
    sl = torch.tensor([7, 5, 3, 7, 1, 6])
    return types.SimpleNamespace(model=m, decs=decs, src=src, sl=sl)


def _delta(before):
    after = launch_counts()
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}


@pytest.mark.gpu
@pytest.mark.parametrize("lut", [False, True], ids=["uniform", "lut"])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gpu_graphed_packed_search_equals_eager(served, lut, cd):
    dec = served.decs["lut" if lut else "uniform", cd]
    cfg = BeamConfig(beam_size=5, max_len=9)
    suffix = "_lut" if lut else ""
    want_launches = {f"dequant_matmul{suffix}": 27, f"dequant_matmul_topk{suffix}": 9,
                     "beam_advance": 9}
    before = launch_counts()
    eager = beam_search_packed(served.model, dec, served.src, served.sl, cfg, _eager=True)
    torch.cuda.synchronize()
    assert _delta(before) == want_launches
    for _ in range(2):  # the capturing call, then a replay
        before = launch_counts()
        graphed = beam_search_packed(served.model, dec, served.src, served.sl, cfg)
        torch.cuda.synchronize()
        assert _delta(before) == want_launches
        assert torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])


@pytest.mark.gpu
def test_gpu_graphed_dense_search_equals_eager(served):
    cfg = BeamConfig(beam_size=4, max_len=8, n_best=2, length_penalty=0.6)
    eager = beam_search(served.model, served.src, served.sl, cfg, _eager=True)
    for _ in range(2):
        before = launch_counts()
        graphed = beam_search(served.model, served.src, served.sl, cfg)
        torch.cuda.synchronize()
        assert _delta(before) == {}  # the dense path launches no kernel of the port
        assert torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])


@pytest.mark.gpu
def test_gpu_new_batch_recaptures(served):
    dec = served.decs["uniform", torch.float32]
    cfg = BeamConfig(beam_size=3, max_len=6)
    beam_search_packed(served.model, dec, served.src, served.sl, cfg)
    n0 = SEARCH_GRAPHS.captures
    beam_search_packed(served.model, dec, served.src, served.sl, cfg)
    assert SEARCH_GRAPHS.captures == n0  # same shape: a replay
    src, sl = served.src[:4], served.sl[:4]
    graphed = beam_search_packed(served.model, dec, src, sl, cfg)
    assert SEARCH_GRAPHS.captures == n0 + 1
    eager = beam_search_packed(served.model, dec, src, sl, cfg, _eager=True)
    assert torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])
    # the same inputs through the earlier graph's key are not mixed up with these
    full = beam_search_packed(served.model, dec, served.src, served.sl, cfg)
    assert full[0].shape[0] == served.src.shape[0]


@pytest.mark.gpu
def test_gpu_capture_with_a_host_sync_raises(cuda):
    from quantized_distillation_tpu_torch.utils.graphs import CapturedCall

    x = torch.ones(4, device=cuda)
    before = launch_counts()
    with pytest.raises(RuntimeError):
        CapturedCall(lambda a: (a * float(a.sum()),), [x])
    assert launch_counts() == before
