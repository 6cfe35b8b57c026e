"""The port's compressed-size accounting (``ops/{huffman,sizes,packing}``)
against the JAX package's on the same inputs: the cases of
``tests/test_ops_sizes.py``, Huffman mean code lengths and entropy, and the
size report of a small seq2seq student from its index streams. Sizes are
sums of integers and the same float arithmetic, so every comparison is
exact."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import QuantSpec
from quantized_distillation_tpu_torch.convert import codebooks_from_numpy, params_from_numpy
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig
from quantized_distillation_tpu_torch.ops import huffman, packing
from quantized_distillation_tpu_torch.ops.sizes import SizeReport, model_size_report
from quantized_distillation_tpu_torch.train import quantize_tree as qt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.models import make_seq2seq
    from quantized_distillation_tpu.ops import huffman as jhuffman
    from quantized_distillation_tpu.ops import packing as jpacking
    from quantized_distillation_tpu.ops import sizes as jsizes
    from quantized_distillation_tpu.train import quantize_tree as jqt

    return types.SimpleNamespace(jax=jax, jnp=jnp, Quant=JQuant, make=make_seq2seq,
                                 huffman=jhuffman, packing=jpacking, sizes=jsizes, qt=jqt)


def _same_report(got: SizeReport, want) -> None:
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.total_bits, got.total_mb, got.compression_ratio) == (
        want.total_bits, want.total_mb, want.compression_ratio)


CASES = {
    # the cases of tests/test_ops_sizes.py, with their closed forms
    "4bit": (({"w": 256 * 10000}, 4), {}, lambda r: abs(r.compression_ratio - 32 / 4.25) < 1e-6),
    "2bit_absmax": (({"w": 256 * 10000}, 2), {"scaling": "absmax"},
                    lambda r: abs(r.compression_ratio - 32 / 2.125) < 1e-6),
    "excluded": (({"first": 1000, "mid": 256000}, 4), {"exclude": ["first"]},
                 lambda r: r.fp_bits == 1000 * 32 and r.quantized_bits == 256000 * 4),
    "per_param_bits": (({"a": 2560, "b": 2560}, {"a": 2, "b": 8}), {},
                       lambda r: r.quantized_bits == 2560 * 2 + 2560 * 8),
    "tail_bucket": (({"w": 300}, 4), {}, lambda r: r.scale_overhead_bits == 2 * 2 * 32),
    "bucket_64": (({"w": 1000, "v": 64}, 8), {"bucket_size": 64},
                  lambda r: r.scale_overhead_bits == (16 + 1) * 2 * 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_size_report_matches_jax(jx, case):
    args, kw, closed_form = CASES[case]
    got = model_size_report(*args, **kw)
    _same_report(got, jx.sizes.model_size_report(*args, **kw))
    assert closed_form(got)


def test_huffman_stream_reduces_size_as_jax(jx):
    rng = np.random.default_rng(0)
    skewed = rng.choice(16, size=25600, p=[0.9] + [1 / 150] * 15)
    got = model_size_report({"w": 25600}, 4, index_streams={"w": skewed})
    _same_report(got, jx.sizes.model_size_report({"w": 25600}, 4, index_streams={"w": skewed}))
    assert got.quantized_bits < 25600 * 4
    assert got.mean_bits_per_weight["w"] < 2.0


@pytest.mark.parametrize("alphabet", [1, 2, 4, 16, 256])
def test_mean_bits_and_entropy_match_jax(jx, alphabet):
    rng = np.random.default_rng(alphabet)
    p = rng.dirichlet(np.ones(alphabet) * 0.4)
    idx = rng.choice(alphabet, size=5000, p=p)
    assert huffman.mean_bits_per_symbol(idx) == jx.huffman.mean_bits_per_symbol(idx)
    assert huffman.entropy_bits_per_symbol(idx) == jx.huffman.entropy_bits_per_symbol(idx)
    freqs = {int(s): int(c) for s, c in zip(*np.unique(idx, return_counts=True))}
    assert huffman.code_lengths(freqs) == jx.huffman.code_lengths(freqs)
    assert huffman.mean_bits_per_symbol([]) == 0.0 == huffman.entropy_bits_per_symbol([])


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_bytes_match_jax(jx, bits):
    rng = np.random.default_rng(bits)
    lv = rng.integers(0, 1 << bits, (3, 512)).astype(np.int32)
    got = packing.pack(torch.from_numpy(lv), bits)
    want = np.asarray(jx.packing.pack(jx.jnp.asarray(lv), bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = packing.unpack(got, bits)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), lv)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jx.packing.unpack(want, bits)))
    with pytest.raises(ValueError):
        packing.values_per_byte(3)
    if bits < 8:
        with pytest.raises(ValueError, match="multiple"):
            packing.pack(torch.from_numpy(lv[:, :3]), bits)


@pytest.mark.parametrize("method", ["uniform", "codebook"])
def test_student_report_from_index_streams_matches_jax(jx, method):
    js = jx.make("student_small", 40, 50, hidden=48, embed_dim=24, num_layers=2, dropout=0.0)
    src = jx.jnp.ones((2, 5), jx.jnp.int32)
    v = js.init(jx.jax.random.PRNGKey(3), src, jx.jnp.full((2,), 5, jx.jnp.int32),
                jx.jnp.ones((2, 3), jx.jnp.int32))
    port = Seq2Seq(Seq2SeqConfig(**dataclasses.asdict(js.cfg)), device="cpu").load_params(
        params_from_numpy(jx.jax.tree.map(np.asarray, v["params"])))
    params = dict(port.named_parameters())
    jspec, spec = jx.Quant(bits=4, method=method), QuantSpec(bits=4, method=method)
    jbooks = jx.qt.init_codebook_tree(v["params"], jspec, "quantile") if method != "uniform" else None
    books = None if jbooks is None else codebooks_from_numpy(
        jx.jax.tree.map(np.asarray, jbooks))
    streams = qt.index_streams(params, spec, books)
    jstreams = jx.qt.index_streams(v["params"], jspec, jbooks)
    assert streams.keys() == jstreams.keys()
    for k in streams:
        np.testing.assert_array_equal(streams[k], np.asarray(jstreams[k]), err_msg=k)
    sizes = qt.param_sizes(params)
    assert sizes == jx.qt.param_sizes(v["params"])
    kw = dict(scaling=spec.scaling, exclude=[k for k in sizes if k not in streams])
    got = model_size_report(sizes, 4, index_streams=streams, **kw)
    _same_report(got, jx.sizes.model_size_report(sizes, 4, index_streams=jstreams, **kw))
    assert 4 < got.compression_ratio < 32 / 4
