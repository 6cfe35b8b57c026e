"""Mesh-sharded serving of the port (slot data parallelism x vocab tensor
parallelism, ``serve/sharded.py`` and ``TranslationEngine(mesh=)``) against
the JAX package's on its 8-device CPU mesh, at the JAX tests' shapes
(``tests/test_sharded_serve.py``: student_small, hidden 128, embed 64, V
64, 4 sentences of 6 tokens, 8-bit f32 decoders).

The port runs one process per rank over gloo (``parallel.launch.run_ranks``,
spawned once per world size: 4 ranks for meshes (2, 2), (1, 4) and (4, 1),
8 ranks for (2, 4) and (8, 1)); the JAX side runs in this process on the
same weights (``convert.params_from_numpy``). Each rank returns its local
results, which the tests hold to the rows of JAX's global arrays:

- the sharded decode step: values and lse within atol 1e-4, indices equal,
  against JAX's sharded step and the port's unsharded step on the same
  rows; three all-gathers over ``model`` a step;
- ``beam_search_sharded``: tokens equal to JAX's and to the port's
  ``beam_search_packed``, scores within atol 1e-4; with the coverage penalty
  and ``return_attention`` the attention within atol 1e-5; a
  ``store_bits=8`` decoder keeps its 4-bit quantization; an exact-LUT
  decoder keeps its codebook (JAX repacks it uniform, so that case is held
  to the port's unsharded LUT search); an indivisible batch raises;
- ``TranslationEngine(mesh=(2, 2))``: every rank returns the completions of
  the offline sharded search; a ``max_slots`` that does not divide the data
  axis raises.

A test marked ``gpu`` runs the sharded search over NCCL at world size 1 on
the card (one CUDA graph with its all-gathers inside) against the unsharded
one. JAX is imported only inside the JAX-side fixture: the spawned ranks
import this module again.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import BeamConfig, ServeConfig
from quantized_distillation_tpu_torch.convert import params_from_numpy, params_to_numpy
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig
from quantized_distillation_tpu_torch.parallel import make_mesh
from quantized_distillation_tpu_torch.parallel.comm import collective_budget
from quantized_distillation_tpu_torch.parallel.launch import run_ranks
from quantized_distillation_tpu_torch.serve import (
    TranslationEngine,
    beam_search_packed,
    beam_search_sharded,
    encode_packed,
    expand_to_beams,
    make_sharded_decode_step_topk,
    pack_decoder,
    packed_decode_step_topk,
    shard_decoder,
)

torch.set_num_threads(2)

VOCAB = 64
K_STEP = 4  # the step test's k
BEAM = dict(beam_size=3, max_len=8)
COVERAGE = dict(beam_size=3, max_len=8, coverage_penalty=0.4)
MESHES4 = [(2, 2), (1, 4), (4, 1)]
MESHES8 = [(2, 4)]
LUT_POINTS = np.random.default_rng(4).uniform(-0.05, 1.05, 16).astype(np.float32)


def _port(payload):
    params = params_from_numpy(payload["params"])
    model = Seq2Seq(Seq2SeqConfig(**payload["cfg"]), device="cpu").load_params(params)
    return params, model


def _local(x, mesh_shape, rank):
    """The rows of ``x`` that rank ``rank`` of a (data, model) mesh holds."""
    dp, mp = mesh_shape
    n = x.shape[0] // dp
    d = rank // mp
    return x[d * n:(d + 1) * n]


def _np(tree):
    return tuple(t.numpy() for t in tree)


def _step_results(params, model, dec, src, sl, mesh_shape, rank):
    """The sharded step on this rank's rows, and the unsharded step on the
    same rows."""
    mesh = make_mesh(*mesh_shape)
    gen = params["generator"]
    sdec = shard_decoder(dec, mesh, gen["kernel"], gen["bias"])
    keys, enc_out, enc_mask, st = encode_packed(model, dec, src, sl)
    rep = lambda t: _local(t.repeat_interleave(K_STEP, dim=0), mesh_shape, rank)  # noqa: E731
    st_b = expand_to_beams(st, K_STEP)
    st_b = dataclasses.replace(st_b, c=_local(st_b.c, mesh_shape, rank),
                               hf=_local(st_b.hf, mesh_shape, rank))
    tok = torch.ones(st_b.c.shape[0], dtype=torch.int64)
    step = make_sharded_decode_step_topk(sdec, mesh, K_STEP)
    with collective_budget(mesh) as budget:
        _, cand = step(st_b, tok, rep(keys), rep(enc_out), rep(enc_mask))
    _, local = packed_decode_step_topk(dec, st_b, tok, rep(keys), rep(enc_out), rep(enc_mask),
                                       K_STEP)
    return {"sharded": _np(cand), "local": _np(local), "gathers": budget.count("all-gather"),
            "contiguous": all(t.is_contiguous() for t in cand),  # as the advance kernel takes
            "axes": sorted({op.axis for op in budget.ops}),
            "gen_width": sdec.generator.shape[1]}


def _rank4(rank, world, payload):
    torch.set_num_threads(2)
    params, model = _port(payload)
    src, sl = torch.from_numpy(payload["src"]).long(), torch.from_numpy(payload["sl"])
    dec = pack_decoder(params, model.cfg, 8, compute_dtype=torch.float32, device="cpu")
    out = {"steps": {s: _step_results(params, model, dec, src, sl, s, rank) for s in MESHES4}}
    mesh = make_mesh(2, 2)
    gen = params["generator"]
    sdec = shard_decoder(dec, mesh, gen["kernel"], gen["bias"])
    beam, cov = BeamConfig(**BEAM), BeamConfig(**COVERAGE)
    with collective_budget(mesh) as budget:
        out["beam"] = _np(beam_search_sharded(model, sdec, src, sl, beam, mesh, device="cpu"))
    out["beam_gathers"] = {a: sum(op.kind == "all-gather" and op.axis == a for op in budget.ops)
                           for a in ("model", "data")}
    out["beam_packed"] = _np(beam_search_packed(model, dec, src, sl, beam, device="cpu"))
    out["coverage"] = _np(beam_search_sharded(model, sdec, src, sl, cov, mesh,
                                              return_attention=True, device="cpu"))
    out["coverage_packed"] = _np(beam_search_packed(model, dec, src, sl, cov,
                                                    return_attention=True, device="cpu"))
    # a byte-stored 4-bit generator: sharded at its quantization bits
    dec4 = pack_decoder(params, model.cfg, 4, compute_dtype=torch.float32,
                        generator_store_bits=8, device="cpu")
    s4 = shard_decoder(dec4, mesh, gen["kernel"], gen["bias"])
    out["store8_bits"] = (s4.generator.bits, s4.generator.effective_quant_bits)
    out["store8"] = _np(beam_search_sharded(model, s4, src, sl, beam, mesh, device="cpu"))
    out["store8_packed"] = _np(beam_search_packed(model, dec4, src, sl, beam, device="cpu"))
    # an exact-LUT generator keeps its codebook
    lut = pack_decoder(params, model.cfg, 4, points=torch.from_numpy(LUT_POINTS),
                       lut_mode="exact", compute_dtype=torch.float32, device="cpu")
    slut = shard_decoder(lut, mesh, gen["kernel"], gen["bias"])
    out["lut_has_points"] = slut.generator.points is not None
    out["lut"] = _np(beam_search_sharded(model, slut, src, sl, beam, mesh, device="cpu"))
    out["lut_packed"] = _np(beam_search_packed(model, lut, src, sl, beam, device="cpu"))
    # the engine on the (2, 2) mesh: 8 requests through 4 slots, 2 a rank
    cfg = ServeConfig(max_slots=4, max_src_len=6, max_tgt_len=8, beam=beam)
    eng = TranslationEngine(model, cfg, sdec, mesh=mesh, device="cpu")
    sents = [list(payload["src"][i][: int(payload["sl"][i])]) for i in range(4)] * 2
    rids = [eng.submit(s) for s in sents]
    done = eng.run_until_drained()
    out["engine"] = {"rids": rids, "done": {c.request_id: c.tokens for c in done},
                     "tokens_emitted": eng.tokens_emitted, "grid": eng._beam.scores.shape[0]}
    mesh41 = make_mesh(4, 1)
    s41 = shard_decoder(dec, mesh41, gen["kernel"], gen["bias"])
    out["refusals"] = _refusals(model, s41, mesh41, src, sl)
    return out


def _refusals(model, sdec, mesh, src, sl):
    """The messages of the refusals on a (dp, 1) mesh: a batch of 3 and 3
    slots do not divide dp = 4 or 8."""
    msgs = []
    for call in (
        lambda: beam_search_sharded(model, sdec, src[:3], sl[:3],
                                    BeamConfig(beam_size=2, max_len=4), mesh, device="cpu"),
        lambda: TranslationEngine(model, ServeConfig(max_slots=3, max_src_len=6, max_tgt_len=8,
                                                     beam=BeamConfig(beam_size=2, max_len=8)),
                                  sdec, mesh=mesh, device="cpu"),
    ):
        try:
            call()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def _rank8(rank, world, payload):
    params, model = _port(payload)
    src, sl = torch.from_numpy(payload["src"]).long(), torch.from_numpy(payload["sl"])
    dec = pack_decoder(params, model.cfg, 8, compute_dtype=torch.float32, device="cpu")
    out = {"steps": {s: _step_results(params, model, dec, src, sl, s, rank) for s in MESHES8}}
    mesh = make_mesh(8, 1)
    gen = params["generator"]
    out["refusals"] = _refusals(model, shard_decoder(dec, mesh, gen["kernel"], gen["bias"]),
                                mesh, src, sl)
    return out


@pytest.fixture(scope="module")
def jx():
    """The JAX model, its weights as the exchange tree, the inputs and the
    JAX package's sharded results on its CPU mesh."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import BeamConfig as JBeam
    from quantized_distillation_tpu.models import make_seq2seq
    from quantized_distillation_tpu.parallel import make_mesh as jmesh
    from quantized_distillation_tpu.serve.infer import encode_packed as jencode
    from quantized_distillation_tpu.serve.infer import pack_decoder as jpack
    from quantized_distillation_tpu.serve.sharded import (
        beam_search_sharded as jbeam,
        make_sharded_decode_step_topk as jstep,
        shard_decoder as jshard,
    )

    m = make_seq2seq("student_small", VOCAB, VOCAB, hidden=128, embed_dim=64, dropout=0.0,
                     num_layers=2)
    src = jax.random.randint(jax.random.PRNGKey(3), (4, 6), 4, VOCAB)
    sl = jnp.full((4,), 6, jnp.int32)
    # jitted: the same weights as the eager init, in a third of the time
    v = jax.jit(m.init)(jax.random.PRNGKey(0), src, sl, jnp.ones((4, 2), jnp.int32))
    dec = jpack(v["params"], m.cfg, 8, compute_dtype=jnp.float32, use_pallas=False)
    gk, gb = v["params"]["generator"]["kernel"], v["params"]["generator"]["bias"]
    keys, enc_out, enc_mask, st = jencode(m, v, dec, src, sl)
    rep = lambda t: jnp.repeat(t, K_STEP, axis=0)  # noqa: E731
    st_b = jax.tree.map(rep, st)
    tok = jnp.ones((src.shape[0] * K_STEP,), jnp.int32)
    steps = {}
    for shape in MESHES4 + MESHES8:
        mesh = jmesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
        sdec = jshard(dec, mesh, gk, gb)
        step = jax.jit(jstep(sdec, mesh, K_STEP))
        _, cand = step(st_b, tok, rep(keys), rep(enc_out), rep(enc_mask))
        steps[shape] = tuple(np.asarray(c) for c in cand)
    mesh = jmesh(2, 2, devices=jax.devices()[:4])
    sdec = jshard(dec, mesh, gk, gb)
    beam = tuple(np.asarray(t) for t in jbeam(m, v, sdec, src, sl, JBeam(**BEAM), mesh))
    cov = tuple(np.asarray(t) for t in jbeam(m, v, sdec, src, sl, JBeam(**COVERAGE), mesh,
                                               return_attention=True))
    return {
        "payload": {
            "params": jax.tree.map(np.asarray, v["params"]),
            "cfg": dataclasses.asdict(m.cfg),
            "src": np.asarray(src),
            "sl": np.asarray(sl),
        },
        "steps": steps,
        "beam": beam,
        "coverage": cov,
    }


@pytest.fixture(scope="module")
def ranks4(jx, tmp_path_factory):
    return run_ranks(_rank4, 4, args=(jx["payload"],), timeout=120, join_timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("ranks4")))


@pytest.fixture(scope="module")
def ranks8(jx, tmp_path_factory):
    return run_ranks(_rank8, 8, args=(jx["payload"],), timeout=120, join_timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("ranks8")))


def _ranks(request, shape):
    return request.getfixturevalue("ranks8" if shape in MESHES8 else "ranks4")


@pytest.mark.parametrize("shape", MESHES4 + MESHES8, ids=str)
def test_sharded_step_matches_jax_and_the_local_step(jx, request, shape):
    jv, ji, jl = jx["steps"][shape]
    for rank, out in enumerate(_ranks(request, shape)):
        res = out["steps"][shape]
        v, i, lse = res["sharded"]
        want = [_local(a, shape, rank) for a in (jv, ji, jl)]
        np.testing.assert_allclose(v, want[0], atol=1e-4)
        np.testing.assert_array_equal(i, want[1])
        np.testing.assert_allclose(lse, want[2], atol=1e-4)
        lv, li, ll = res["local"]
        np.testing.assert_allclose(v, lv, atol=1e-4)
        np.testing.assert_array_equal(i, li)
        np.testing.assert_allclose(lse, ll, atol=1e-4)


@pytest.mark.parametrize("shape", MESHES4 + MESHES8, ids=str)
def test_sharded_step_gathers_three_times_over_model(request, shape):
    """Three all-gathers a step, candidates contiguous, the shard width."""
    for out in _ranks(request, shape):
        res = out["steps"][shape]
        assert res["gathers"] == 3
        assert res["contiguous"]
        # an axis of size 1 still issues its collective; its groups are singletons
        assert res["axes"] == (["model"] if shape[1] > 1 else ["unknown"])
        # the shard width: the generator padded to mp * 16 * 256 columns, split
        assert res["gen_width"] == 16 * 256


def test_beam_search_sharded_matches_jax_and_the_packed_search(jx, ranks4):
    jt, js = jx["beam"]
    for out in ranks4:
        t, s = out["beam"]
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_allclose(s, js, atol=1e-4)
        pt, ps = out["beam_packed"]
        np.testing.assert_array_equal(t, pt)
        np.testing.assert_allclose(s, ps, atol=1e-4)
        # 3 gathers over model a step, the results once over data
        assert out["beam_gathers"] == {"model": 3 * BEAM["max_len"], "data": 2}


def test_coverage_and_attention_match_jax_and_the_packed_search(jx, ranks4):
    jt, js, ja = jx["coverage"]
    for out in ranks4:
        t, s, a = out["coverage"]
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_allclose(s, js, atol=1e-4)
        np.testing.assert_allclose(a, ja, atol=1e-5)
        pt, ps, pa = out["coverage_packed"]
        np.testing.assert_array_equal(t, pt)
        np.testing.assert_allclose(s, ps, atol=1e-4)
        np.testing.assert_allclose(a, pa, atol=1e-5)


def test_store8_decoder_keeps_its_quantization(ranks4):
    for out in ranks4:
        assert out["store8_bits"] == (8, 4)
        np.testing.assert_array_equal(out["store8"][0], out["store8_packed"][0])
        np.testing.assert_allclose(out["store8"][1], out["store8_packed"][1], atol=1e-4)


def test_exact_lut_decoder_keeps_its_codebook(ranks4):
    for out in ranks4:
        assert out["lut_has_points"]
        np.testing.assert_array_equal(out["lut"][0], out["lut_packed"][0])
        np.testing.assert_allclose(out["lut"][1], out["lut_packed"][1], atol=1e-4)


def test_engine_on_mesh_matches_offline_sharded_search(jx, ranks4):
    for out in ranks4:
        eng = out["engine"]
        assert eng["grid"] == 2  # this rank's 2 of the 4 slots
        rids = eng["rids"]
        assert sorted(eng["done"]) == sorted(rids)
        t_ref = out["beam"][0]
        for i in range(4):
            np.testing.assert_array_equal(eng["done"][rids[i]], t_ref[i])
            np.testing.assert_array_equal(eng["done"][rids[i + 4]], t_ref[i])
    assert len({out["engine"]["tokens_emitted"] for out in ranks4}) == 1


@pytest.mark.parametrize("world", [4, 8])
def test_indivisible_batch_and_slots_raise(request, world):
    for out in request.getfixturevalue(f"ranks{world}"):
        beam_msg, engine_msg = out["refusals"]
        assert beam_msg is not None and "must divide data axis" in beam_msg
        assert engine_msg is not None and "max_slots 3 must divide" in engine_msg


def _gpu_rank(rank, world, payload):
    """NCCL at world size 1 on the card: the sharded search (one CUDA graph,
    its all-gathers inside) against the unsharded one, f32."""
    from quantized_distillation_tpu_torch.kernels import launch_counts, set_launch_counts

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = params_from_numpy(payload["params"])
    model = Seq2Seq(Seq2SeqConfig(**payload["cfg"]), device=dev).load_params(params)
    src, sl = torch.from_numpy(payload["src"]).long(), torch.from_numpy(payload["sl"])
    dec = pack_decoder(params, model.cfg, 4, compute_dtype=torch.float32, device=dev)
    mesh = make_mesh(1, 1)
    sdec = shard_decoder(dec, mesh, params["generator"]["kernel"], params["generator"]["bias"])
    beam = BeamConfig(**BEAM)
    set_launch_counts({n: 0 for n in launch_counts()})
    with collective_budget(mesh) as budget:
        toks, scores = beam_search_sharded(model, sdec, src, sl, beam, mesh, device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()  # the sharded search's alone
    ptoks, pscores = beam_search_packed(model, dec, src, sl, beam, device=dev)
    return {"equal": torch.equal(toks, ptoks), "score_diff": float((scores - pscores).abs().max()),
            "launches": {n: counts[n] for n in ("dequant_matmul", "dequant_matmul_topk",
                                                "beam_advance")},
            "gathers": budget.count("all-gather")}


@pytest.mark.gpu
def test_gpu_nccl_sharded_search_equals_packed(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    rng = np.random.default_rng(0)
    model = Seq2Seq(Seq2SeqConfig(src_vocab=VOCAB, tgt_vocab=VOCAB, embed_dim=64, hidden=128,
                                  num_layers=2, dropout=0.0), device="cpu", seed=0)
    payload = {"params": params_to_numpy(model), "cfg": dataclasses.asdict(model.cfg),
               "src": rng.integers(4, VOCAB, (4, 6)).astype(np.int32),
               "sl": np.full(4, 6, np.int32)}
    (out,) = run_ranks(_gpu_rank, 1, args=(payload,), backend="nccl", timeout=120,
                       join_timeout=300, store_dir=str(tmp_path))
    assert out["equal"] and out["score_diff"] == 0.0
    steps = BEAM["max_len"]
    assert out["launches"] == {"dequant_matmul": 3 * steps, "dequant_matmul_topk": steps,
                               "beam_advance": steps}
    assert out["gathers"] == 3 * steps + 2
