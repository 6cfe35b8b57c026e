"""The port's host codec (``native``) and ``.qdt`` artifacts against the JAX
package's, and the deploy loop from a file on disk.

- Codec: the C++ library round-trips, equals the ``*_plain`` Python codec
  and the JAX package's ``native`` functions (payload bytes, code lengths,
  bit counts; the degenerate one-symbol stream too); packing and batch
  assembly likewise. Exact.
- Artifacts: the port's ``save_artifact`` writes the JAX package's file byte
  for byte for the same weights (a seq2seq student, whose fused LSTM
  tensors are split into flax's gate leaves, and a CNN, whose OIHW conv
  kernels are written in flax's HWIO layout; uniform at 2/4/8 bits with
  linear and abs-max scaling, learned codebooks, a bits map, meta; the
  uniform and codebook files also for a WideResNet, a ResNet with the small
  stem and basic blocks, one with the ImageNet stem and bottleneck blocks,
  and the LSTM LM untied and tied), and its
  ``load_artifact`` restores a JAX-written file to the JAX package's values
  bit for bit.
- Deploy loop (JAX's ``tests/test_native_artifact.py`` end to end): a
  JAX-written ``.qdt`` served by the port's ``beam_search_packed`` (plain
  versions, f32, CPU) gives JAX's tokens, scores within 1e-4; from disk vs
  from memory within that test's own tolerances (>= 0.9 of the tokens,
  scores rtol 1e-3).

The JAX package is imported inside a fixture; the ``gpu`` test runs on the
card without it."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch import native
from quantized_distillation_tpu_torch.config import BeamConfig, QuantSpec
from quantized_distillation_tpu_torch.convert import (
    codebooks_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from quantized_distillation_tpu_torch.models import CNNSpec, ConvForwardNet, Seq2Seq, Seq2SeqConfig
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.ops.huffman import mean_bits_per_symbol
from quantized_distillation_tpu_torch.serve import infer
from quantized_distillation_tpu_torch.train.quantize_tree import (
    init_codebook_tree,
    quantize_tree_hard,
)
from quantized_distillation_tpu_torch.utils.artifact import load_artifact, save_artifact

torch.set_num_threads(2)

CNN = dict(conv=((16, True), (8, False), (24, True)), fc=(32,), num_classes=10, dropout=0.0)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu import native as jnative
    from quantized_distillation_tpu.config import BeamConfig as JBeam
    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.models import cnn
    from quantized_distillation_tpu.models import make_seq2seq as jmake
    from quantized_distillation_tpu.serve import infer as jinfer
    from quantized_distillation_tpu.train import quantize_tree as jqt
    from quantized_distillation_tpu.utils import artifact as jart

    assert jnative.available()  # the JAX package's C++ path, not its Python fallback
    return types.SimpleNamespace(jax=jax, jnp=jnp, native=jnative, Beam=JBeam, Quant=JQuant,
                                 cnn=cnn, make=jmake, infer=jinfer, qt=jqt, art=jart)


def _np_tree(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def seq2seq(jx):
    """A flax seq2seq student (H = 48: gate blocks not bucket-aligned) and the
    port model holding the same weights."""
    jm = jx.make("student_small", 40, 50, hidden=48, embed_dim=24, num_layers=2, dropout=0.0)
    src = jx.jnp.ones((2, 5), jx.jnp.int32)
    v = jm.init(jx.jax.random.PRNGKey(0), src, jx.jnp.full((2,), 5, jx.jnp.int32),
                jx.jnp.ones((2, 3), jx.jnp.int32))
    port = Seq2Seq(Seq2SeqConfig(**dataclasses.asdict(jm.cfg)), device="cpu").load_params(
        params_from_numpy(_np_tree(jx, v["params"])))
    return jm, v["params"], port


@pytest.fixture(scope="module")
def cnn(jx):
    jm = jx.cnn.ConvForwardNet(jx.cnn.CNNSpec(**CNN))
    v = jm.init(jx.jax.random.PRNGKey(1), jx.jnp.zeros((1, 9, 9, 3)))
    port = ConvForwardNet(CNNSpec(**CNN), image_size=9, device="cpu")
    port.load_params(_np_tree(jx, v["params"]))
    return jm, v["params"], port


VISION = {  # the other families, at small widths (tests/test_torch_vision.py's)
    "wrn": dict(depth=10, widen=1, num_classes=10),
    "resnet_basic": dict(stage_sizes=(1, 1), width_mult=0.25, num_classes=10,
                         small_inputs=True),
    "resnet_imagenet_bottleneck": dict(stage_sizes=(1, 1), bottleneck=True, width_mult=0.25,
                                       num_classes=10),
}
# wide enough that the weights, not the header, fill the file
LMS = {"lm": dict(embed_dim=32, hidden=64), "lm_tied": dict(embed_dim=64, hidden=64,
                                                           tie_embeddings=True)}
FAMILIES = ["seq2seq", "cnn"] + list(VISION) + list(LMS)


def _filled(jx, init, *args):
    """Seeded values in the tree ``init`` gives (shapes from
    ``jax.eval_shape``, which runs no initializer)."""
    rng = np.random.default_rng(len(args))
    shapes = jx.jax.eval_shape(init, jx.jax.random.PRNGKey(0), *args)["params"]
    return jx.jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
                           dict(shapes))


def _make_family(jx, name):
    """(flax module, its params, the port model holding the same) of a
    WideResNet, a ResNet or an LSTM LM."""
    from quantized_distillation_tpu.models import lm as jlm
    from quantized_distillation_tpu.models import resnet as jresnet
    from quantized_distillation_tpu.models import wide_resnet as jwrn

    from quantized_distillation_tpu_torch.models import ResNet, WideResNet, make_lm

    if name in VISION:
        kw = VISION[name]
        jm = jwrn.WideResNet(**kw) if name == "wrn" else jresnet.ResNet(**kw)
        params = _filled(jx, jm.init, jx.jnp.zeros((1, 8, 8, 3)))
        port = (WideResNet if name == "wrn" else ResNet)(device="cpu", **kw)
    else:
        jm = jlm.make_lm("student_small", 30, **LMS[name])
        params = _filled(jx, jm.init, jx.jnp.zeros((1, 3), jx.jnp.int32))
        port = make_lm("student_small", 30, device="cpu", **LMS[name])
    port.load_params(params)
    return jm, params, port


_FAMILIES = {}  # built once in this module


def _family(jx, request, model):
    """The ``seq2seq`` or ``cnn`` fixture, or a twin of another family."""
    if model in ("seq2seq", "cnn"):
        return request.getfixturevalue(model)
    if model not in _FAMILIES:
        _FAMILIES[model] = _make_family(jx, model)
    return _FAMILIES[model]


# ------------------------------------------------------------------ codec


def _stream(alphabet, seed, n=20000):
    rng = np.random.default_rng(seed)
    return rng.choice(alphabet, size=n, p=rng.dirichlet(np.ones(alphabet) * 0.4)).astype(np.int32)


STREAMS = [(2, 0), (4, 1), (16, 2), (16, 3), (256, 4)]


@pytest.mark.parametrize("alphabet,seed", STREAMS)
def test_codec_round_trips_and_equals_plain_and_jax(jx, alphabet, seed):
    idx = _stream(alphabet, seed)
    payload, lens, nbits = native.huffman_encode(idx, alphabet)
    np.testing.assert_array_equal(native.huffman_decode(payload, nbits, lens, idx.size), idx)
    assert nbits / idx.size == pytest.approx(mean_bits_per_symbol(idx))  # an optimal code
    jp, jl, jn = jx.native.huffman_encode(idx, alphabet)
    assert (payload, nbits) == (jp, jn)
    np.testing.assert_array_equal(lens, jl)
    pp, pl, pn = native.huffman_encode_plain(idx, alphabet)
    assert (pp, pn) == (payload, nbits)
    np.testing.assert_array_equal(pl, lens)
    np.testing.assert_array_equal(native.huffman_decode_plain(payload, nbits, lens, idx.size),
                                  idx)
    np.testing.assert_array_equal(jx.native.huffman_decode(payload, nbits, lens, idx.size), idx)


@pytest.mark.parametrize("n", [0, 1, 100])
def test_codec_single_symbol_and_empty_streams(jx, n):
    idx = np.full(n, 3, np.int32)
    got = native.huffman_encode(idx, 4)
    for other in (jx.native.huffman_encode(idx, 4), native.huffman_encode_plain(idx, 4)):
        assert (got[0], got[2]) == (other[0], other[2])
        np.testing.assert_array_equal(got[1], other[1])
    assert got[2] == n  # one bit a symbol
    np.testing.assert_array_equal(native.huffman_decode(got[0], got[2], got[1], n), idx)


def test_codec_rejects_bad_streams():
    with pytest.raises(ValueError, match="symbol"):
        native.huffman_encode(np.array([0, 4], np.int32), 4)
    payload, lens, nbits = native.huffman_encode(_stream(4, 0, 100), 4)
    with pytest.raises(ValueError, match="malformed"):
        native.huffman_decode(payload, nbits - 3, lens, 100)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_stream_matches_jax_and_plain(jx, bits):
    lv = np.random.default_rng(bits).integers(0, 1 << bits, 2048).astype(np.int32)
    packed = native.pack_stream(lv, bits)
    np.testing.assert_array_equal(packed, jx.native.pack_stream(lv, bits))
    np.testing.assert_array_equal(packed, native.pack_stream_plain(lv, bits))
    np.testing.assert_array_equal(native.unpack_stream(packed, bits), lv)
    np.testing.assert_array_equal(native.unpack_stream_plain(packed, bits), lv)
    with pytest.raises(ValueError):
        native.pack_stream(np.full(8, 1 << bits, np.int32), bits)


@pytest.mark.parametrize("sents,max_len,pad", [
    ([[5, 6, 7], [8], list(range(10, 30))], 8, 0),
    ([[], [4, 4]], 3, 9),
    ([], 4, 0),
])
def test_pad_batch_matches_jax(jx, sents, max_len, pad):
    got = native.pad_batch(sents, max_len, pad)
    for want in (jx.native.pad_batch(sents, max_len, pad),
                 native.pad_batch_plain(sents, max_len, pad)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------- artifacts


def _pair(tmp_path, jx, jparams, port, spec_kw, books=None, **kw):
    """Both packages' files for the same weights (``books``: the JAX
    package's codebook tree) → (JAX bytes, port bytes, the port's stats)."""
    pbooks = None if books is None else codebooks_from_numpy(_np_tree(jx, books))
    jstats = jx.art.save_artifact(str(tmp_path / "j.qdt"), jparams, jx.Quant(**spec_kw),
                                  codebooks=books, **kw)
    stats = save_artifact(str(tmp_path / "p.qdt"), port, QuantSpec(**spec_kw), codebooks=pbooks,
                          **kw)
    assert stats == jstats
    return (tmp_path / "j.qdt").read_bytes(), (tmp_path / "p.qdt").read_bytes(), stats


SPECS = [dict(bits=b, scaling=s) for b in (2, 4, 8) for s in ("linear", "absmax")]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s['bits']}bit-{s['scaling']}")
@pytest.mark.parametrize("model", FAMILIES)
def test_uniform_file_equals_jax_byte_for_byte(jx, request, tmp_path, model, spec):
    _, jparams, port = _family(jx, request, model)
    jbytes, pbytes, stats = _pair(tmp_path, jx, jparams, port, spec)
    assert pbytes == jbytes
    assert stats["file_bytes"] == len(pbytes) and stats["compression_ratio"] > 2


@pytest.mark.parametrize("model", FAMILIES)
@pytest.mark.parametrize("init", ["uniform", "quantile"])
def test_codebook_file_equals_jax_byte_for_byte(jx, request, tmp_path, model, init):
    _, jparams, port = _family(jx, request, model)
    spec = dict(bits=4, method="codebook")
    books = jx.qt.init_codebook_tree(jparams, jx.Quant(**spec), init)
    if init == "quantile":  # learned-looking points, unsorted, some outside [0, 1]
        rng = np.random.default_rng(0)
        books = {k: v + rng.normal(0, 0.05, v.shape).astype(np.float32)
                 for k, v in _np_tree(jx, books).items()}
    jbytes, pbytes, _ = _pair(tmp_path, jx, jparams, port, spec, books=books)
    assert pbytes == jbytes


def test_bits_map_and_meta_file_equals_jax(jx, seq2seq, tmp_path):
    _, jparams, port = seq2seq
    bits_map = {"generator/kernel": 8, "decoder/lstm_0/hi/kernel": 2,
                "encoder/embed/embedding": 2}
    meta = {"run": "test", "step": 7, "nested": {"bleu": 12.5, "tags": ["a", "b"]}}
    jbytes, pbytes, _ = _pair(tmp_path, jx, jparams, port, dict(bits=4), bits_map=bits_map,
                              meta=meta)
    assert pbytes == jbytes
    _, got_meta = load_artifact(str(tmp_path / "p.qdt"), port, device="cpu")
    assert got_meta == meta


@pytest.mark.parametrize("spec", [dict(bits=4), dict(bits=2, scaling="absmax"),
                                  dict(bits=4, method="codebook")], ids=str)
@pytest.mark.parametrize("model", ["seq2seq", "cnn"])
def test_load_of_a_jax_file_equals_jax_load(jx, request, tmp_path, model, spec):
    _, jparams, port = request.getfixturevalue(model)
    books = None
    if spec.get("method") == "codebook":
        books = jx.qt.init_codebook_tree(jparams, jx.Quant(**spec), "quantile")
    path = str(tmp_path / "j.qdt")
    jx.art.save_artifact(path, jparams, jx.Quant(**spec), codebooks=books)
    want, _ = jx.art.load_artifact(path, jparams)
    got, _ = load_artifact(path, port, device="cpu")
    assert got.keys() == dict(port.named_parameters()).keys()
    for a, b in zip(jx.jax.tree_util.tree_leaves_with_path(params_to_numpy(got)),
                    jx.jax.tree_util.tree_leaves_with_path(want)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], np.asarray(b[1]), err_msg=str(a[0]))
    # and the port's own hard quantization of the saved weights, to rounding
    hard = quantize_tree_hard(dict(port.named_parameters()), QuantSpec(**spec),
                              None if books is None else
                              codebooks_from_numpy(_np_tree(jx, books)))
    for name, t in got.items():
        torch.testing.assert_close(t, hard[name], rtol=0, atol=1e-6)


def test_load_checks_the_template(seq2seq, tmp_path):
    _, _, port = seq2seq
    save_artifact(str(tmp_path / "m.qdt"), port, QuantSpec(bits=4))
    other = make_seq2seq("student_small", 40, 50, hidden=32, embed_dim=24, num_layers=2,
                         device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_artifact(str(tmp_path / "m.qdt"), other, device="cpu")
    (tmp_path / "bad.qdt").write_bytes(b"NOPE" + bytes(12))
    with pytest.raises(ValueError, match="not a QDTA"):
        load_artifact(str(tmp_path / "bad.qdt"), port, device="cpu")


def test_load_to_a_missing_card_raises(seq2seq, tmp_path, monkeypatch):
    _, _, port = seq2seq
    save_artifact(str(tmp_path / "m.qdt"), port, QuantSpec(bits=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        load_artifact(str(tmp_path / "m.qdt"), port)  # device defaults to the card


# -------------------------------------------------------------- the deploy loop


def _deploy_twin(jx):
    jm = jx.make("student_small", 40, 50, hidden=64, embed_dim=32, dropout=0.0)
    rng = np.random.default_rng(5)
    src = rng.integers(4, 40, (4, 10)).astype(np.int32)
    sl = np.array([10, 7, 3, 10], np.int32)
    v = jm.init(jx.jax.random.PRNGKey(0), jx.jnp.asarray(src), jx.jnp.asarray(sl),
                jx.jnp.ones((4, 2), jx.jnp.int32))
    return jm, v["params"], src, sl


def _port_serve(cfg, params, bits, src, sl, beam):
    """The port's packed search with the deployment weights ``params``."""
    tree = params_to_numpy(params)
    model = Seq2Seq(cfg, device="cpu").load_params(tree)
    dec = infer.pack_decoder(tree, cfg, bits, compute_dtype=torch.float32, device="cpu")
    return infer.beam_search_packed(model, dec, torch.from_numpy(src).long(),
                                    torch.from_numpy(sl).long(), BeamConfig(**beam),
                                    device="cpu")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("beam", [dict(beam_size=3, max_len=8),
                                  dict(beam_size=4, max_len=7, length_penalty=0.6)], ids=str)
def test_jax_file_served_by_the_port_gives_jax_tokens(jx, tmp_path, bits, beam):
    jm, jparams, src, sl = _deploy_twin(jx)
    path = str(tmp_path / "deploy.qdt")
    jx.art.save_artifact(path, jparams, jx.Quant(bits=bits))
    jrest, _ = jx.art.load_artifact(path, jparams)
    jdec = jx.infer.pack_decoder(jrest, jm.cfg, bits, compute_dtype=jx.jnp.float32,
                                 use_pallas=False)
    jt, js = jx.infer.beam_search_packed(jm, {"params": jrest}, jdec, jx.jnp.asarray(src),
                                         jx.jnp.asarray(sl), jx.Beam(**beam))
    cfg = Seq2SeqConfig(**dataclasses.asdict(jm.cfg))
    template = dict(Seq2Seq(cfg, device="cpu").named_parameters())
    restored, _ = load_artifact(path, template, device="cpu")
    tt, ts = _port_serve(cfg, restored, bits, src, sl, beam)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


def test_from_disk_agrees_with_from_memory(jx, tmp_path):
    """The port's own loop: trained weights → .qdt → load → packed search,
    against serving the in-memory hard-quantized weights (the artifact
    dequantizes in another operation order, so values agree to ~1 ulp and
    near-tied beams may flip late tokens)."""
    jm, jparams, src, sl = _deploy_twin(jx)
    cfg = Seq2SeqConfig(**dataclasses.asdict(jm.cfg))
    model = Seq2Seq(cfg, device="cpu").load_params(params_from_numpy(_np_tree(jx, jparams)))
    spec = QuantSpec(bits=4)
    stats = save_artifact(str(tmp_path / "deploy.qdt"), model, spec)
    assert stats["compression_ratio"] > 3
    restored, _ = load_artifact(str(tmp_path / "deploy.qdt"), model, device="cpu")
    hard = quantize_tree_hard(dict(model.named_parameters()), spec)
    beam = dict(beam_size=3, max_len=8)
    t_mem, s_mem = _port_serve(cfg, hard, 4, src, sl, beam)
    t_disk, s_disk = _port_serve(cfg, restored, 4, src, sl, beam)
    assert float((t_mem == t_disk).float().mean()) >= 0.9
    np.testing.assert_allclose(s_mem.numpy(), s_disk.numpy(), rtol=1e-3)


def test_codebook_file_serves_the_exact_lut_deploy(jx, tmp_path):
    """A codebook artifact's points, read back, pack the exact-LUT decoder,
    whose tokens equal the in-memory deploy's."""
    jm, jparams, src, sl = _deploy_twin(jx)
    cfg = Seq2SeqConfig(**dataclasses.asdict(jm.cfg))
    model = Seq2Seq(cfg, device="cpu").load_params(params_from_numpy(_np_tree(jx, jparams)))
    spec = QuantSpec(bits=4, method="codebook")
    books = init_codebook_tree(dict(model.named_parameters()), spec, "quantile")
    save_artifact(str(tmp_path / "cb.qdt"), model, spec, codebooks=books)
    restored, _ = load_artifact(str(tmp_path / "cb.qdt"), model, device="cpu")
    hard = quantize_tree_hard(dict(model.named_parameters()), spec, books)
    for name, t in restored.items():
        torch.testing.assert_close(t, hard[name], rtol=0, atol=1e-6)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_artifact_served_from_disk_matches_cpu(cuda, tmp_path):
    """A port-written file loaded onto the card holds the CPU load's values,
    and the graphed packed search from it (f32) gives the CPU path's
    tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = make_seq2seq("student_small", 40, 50, hidden=64, embed_dim=32, device="cpu",
                         seed=3)
    save_artifact(str(tmp_path / "m.qdt"), model, QuantSpec(bits=4))
    on_cpu, _ = load_artifact(str(tmp_path / "m.qdt"), model, device="cpu")
    on_card, _ = load_artifact(str(tmp_path / "m.qdt"), model, device=cuda)
    for name, t in on_card.items():
        assert t.device.type == "cuda"
        assert torch.equal(t.cpu(), on_cpu[name])
    gen = torch.Generator().manual_seed(0)
    src = torch.randint(4, 40, (6, 9), generator=gen)
    sl = torch.full((6,), 9)
    cfg = BeamConfig(beam_size=3, max_len=8)
    outs = {}
    for dev, params in (("cpu", on_cpu), ("cuda", on_card)):
        tree = params_to_numpy(params)
        m = Seq2Seq(model.cfg, device=dev).load_params(tree)
        dec = infer.pack_decoder(tree, model.cfg, 4, compute_dtype=torch.float32, device=dev)
        outs[dev] = infer.beam_search_packed(m, dec, src, sl, cfg, device=dev)
    assert torch.equal(outs["cuda"][0].cpu(), outs["cpu"][0])
    torch.testing.assert_close(outs["cuda"][1].cpu(), outs["cpu"][1], rtol=1e-5, atol=1e-5)
