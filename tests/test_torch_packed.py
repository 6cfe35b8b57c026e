"""The PyTorch port's packed weight format against the JAX package's: the
same weights must give identical bytes and bit-equal scale/offset."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_distillation_tpu.kernels import packed as jpk
from quantized_distillation_tpu.serve.sharded import (
    pack_generator_sharded as jax_pack_generator_sharded,
)
from quantized_distillation_tpu_torch.kernels import packed as tpk
from quantized_distillation_tpu_torch.ops import bucketing as tbk
from quantized_distillation_tpu_torch.ops.uniform import quantize_levels_01
from quantized_distillation_tpu_torch.serve.sharded import pack_generator_sharded

torch.set_num_threads(2)


def _assert_same_packed(jp, tp):
    np.testing.assert_array_equal(np.asarray(jp.packed), tp.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jp.offset), tp.offset.numpy())
    assert (jp.bits, jp.shape, jp.group, jp.quant_bits) == (
        tp.bits, tp.shape, tp.group, tp.quant_bits,
    )
    if jp.bias is None:
        assert tp.bias is None
    else:
        np.testing.assert_array_equal(np.asarray(jp.bias), tp.bias.numpy())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n", [512, 300])  # 300: edge-padded to a bucket group
@pytest.mark.parametrize("scaling", ["linear", "absmax"])
def test_pack_linear_bytes_identical(bits, n, scaling):
    rng = np.random.default_rng(bits * 1000 + n)
    w = rng.standard_normal((48, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    jp = jpk.pack_linear(jnp.asarray(w), bits, scaling=scaling, bias=jnp.asarray(bias))
    tp = tpk.pack_linear(torch.from_numpy(w), bits, scaling=scaling, bias=torch.from_numpy(bias))
    _assert_same_packed(jp, tp)


@pytest.mark.parametrize("bits", [2, 4])
def test_store_bits_8_bytes_identical(bits):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((32, 768)).astype(np.float32)
    jp = jpk.pack_linear(jnp.asarray(w), bits, store_bits=8)
    tp = tpk.pack_linear(torch.from_numpy(w), bits, store_bits=8)
    _assert_same_packed(jp, tp)
    # dequantized values match the sub-byte container bit for bit
    sub = tpk.pack_linear(torch.from_numpy(w), bits)
    assert torch.equal(tpk.dequantize_linear(tp), tpk.dequantize_linear(sub))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plane_unpack_and_dequantize_equal(bits):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((24, 600)).astype(np.float32)
    jp = jpk.pack_linear(jnp.asarray(w), bits, max_group=2)
    tp = tpk.pack_linear(torch.from_numpy(w), bits, max_group=2)
    np.testing.assert_array_equal(
        np.asarray(jpk.plane_unpack(jp.packed, bits)), tpk.plane_unpack(tp.packed, bits).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jpk.dequantize_linear(jp)), tpk.dequantize_linear(tp).numpy()
    )
    assert tpk.dequantize_linear(tp).shape == (24, 600)


@pytest.mark.parametrize("n", [200, 256, 1000])
def test_bucket_group_matches(n):
    for bits in (2, 4, 8):
        for mg in (None, 2, 16):
            assert tpk.bucket_group(bits, n, mg) == jpk.bucket_group(bits, n, mg)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_generator_sharded_matches(bits):
    rng = np.random.default_rng(3)
    kern = rng.standard_normal((32, 600)).astype(np.float32)
    bias = rng.standard_normal(600).astype(np.float32)
    jp = jax_pack_generator_sharded(jnp.asarray(kern), jnp.asarray(bias), bits, 1, max_group=2)
    tp = pack_generator_sharded(torch.from_numpy(kern), torch.from_numpy(bias), bits, 1, max_group=2)
    _assert_same_packed(jp, tp)
    assert tp.shape == (32, 1024)
    assert torch.all(tp.bias[600:] == -1e9)


def test_quantize_levels_rounds_half_to_even():
    x01 = torch.tensor([0.5, 1.5, 2.5, 3.5, 14.5]) / 15.0
    got = quantize_levels_01(x01 * 1.0, 4)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x01.numpy()) * 15), 0, 15))
    np.testing.assert_array_equal(got.numpy(), want)


def test_to_buckets_and_scale_match_jax():
    from quantized_distillation_tpu.ops import bucketing as jbk

    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 77)).astype(np.float32)
    jb, jn = jbk.to_buckets(jnp.asarray(x))
    tb, tn = tbk.to_buckets(torch.from_numpy(x))
    assert jn == tn
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    for kind in (tbk.LINEAR, tbk.ABSMAX):
        js, ts = jbk.compute_scale(jb, kind), tbk.compute_scale(tb, kind)
        np.testing.assert_array_equal(np.asarray(js.offset), ts.offset.numpy())
        np.testing.assert_array_equal(np.asarray(js.scale), ts.scale.numpy())


def _points(rng, bits):
    """Trained-looking codebook: out of order, partly outside [0, 1], with a
    collision."""
    pts = rng.uniform(-0.1, 1.1, 1 << bits).astype(np.float32)
    pts[1] = pts[-1]
    return pts


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("lut_mode", ["exact", "requant8"])
@pytest.mark.parametrize("n", [512, 300])
def test_codebook_pack_linear_bytes_identical(bits, lut_mode, n):
    rng = np.random.default_rng(bits * 100 + n)
    w = rng.standard_normal((40, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    pts = _points(rng, bits)
    jp = jpk.pack_linear(jnp.asarray(w), bits, points=jnp.asarray(pts), bias=jnp.asarray(bias),
                         lut_mode=lut_mode, max_group=2)
    tp = tpk.pack_linear(torch.from_numpy(w), bits, points=torch.from_numpy(pts),
                         bias=torch.from_numpy(bias), lut_mode=lut_mode, max_group=2)
    _assert_same_packed(jp, tp)
    if lut_mode == "exact":
        np.testing.assert_array_equal(np.asarray(jp.points), tp.points.numpy())
    else:
        assert jp.points is None and tp.points is None and tp.bits == 8
    np.testing.assert_array_equal(np.asarray(jpk.dequantize_linear(jp)),
                                  tpk.dequantize_linear(tp).numpy())


def test_codebook_packing_not_ported():
    """Named when codebook packing was not ported yet: now the port packs
    a learned codebook, refuses what the JAX package refuses, and moves the
    LUT with the matrix."""
    w, pts = torch.zeros(4, 256), torch.linspace(0, 1, 16)
    with pytest.raises(ValueError, match="requant8"):
        tpk.pack_linear(w, 4, points=pts, store_bits=8)
    with pytest.raises(ValueError, match="lut_mode"):
        tpk.pack_linear(w, 4, points=pts, lut_mode="lut")
    p = tpk.pack_linear(w, 4, points=pts)
    assert p.points.dtype == torch.float32
    moved = p.to("meta")  # every tensor moves, the LUT too
    assert {t.device.type for t in (moved.packed, moved.scale, moved.offset, moved.points)} == {"meta"}
