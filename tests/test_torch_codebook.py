"""The PyTorch port's learned-codebook quantization (``ops/codebook.py``)
against the JAX package's, on the same inputs (numpy, from seeds).

Tolerances (f32 on the CPU): nearest-point indices exactly, for sorted,
unsorted, colliding and out-of-[0, 1] points and exact midpoints; the
uniform and quantile initial points exactly (the quantile also over a run
of equal values, as a leaf's edge padding makes); fake-quant values within 2e-6 (as
tests/test_kernels.py states for the uniform fake-quant); gradients to the
points within 1e-5 of their largest |gradient| (a scatter-add over 256-wide
buckets, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_distillation_tpu.ops import codebook as jcb
from quantized_distillation_tpu_torch.ops import codebook as tcb

torch.set_num_threads(2)

VALUE_ATOL = 2e-6
GRAD_TOL = 1e-5


def _points(kind, bits, rng):
    s = 1 << bits
    if kind == "sorted":
        return np.sort(rng.uniform(0, 1, s)).astype(np.float32)
    if kind == "unsorted":
        return rng.uniform(0, 1, s).astype(np.float32)
    if kind == "colliding":
        pts = rng.uniform(0, 1, s).astype(np.float32)
        pts[::3] = pts[1]
        return pts
    return rng.uniform(-0.4, 1.4, s).astype(np.float32)  # drifted out of [0, 1]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "colliding", "outside"])
def test_nearest_point_idx_equals_jax(bits, kind):
    rng = np.random.default_rng(bits * 7 + len(kind))
    pts = _points(kind, bits, rng)
    sp = np.unique(pts)
    mids = ((sp[:-1] + sp[1:]) / 2).astype(np.float32)  # exact midpoints: ties go low
    x = np.concatenate([rng.uniform(-0.5, 1.5, 4000).astype(np.float32), mids, pts,
                        np.float32([0.0, 1.0])])
    want = np.asarray(jcb.nearest_point_idx(jnp.asarray(x), jnp.asarray(pts)))
    got = tcb.nearest_point_idx(torch.from_numpy(x), torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_init_points_match_jax(bits):
    rng = np.random.default_rng(bits)
    np.testing.assert_array_equal(tcb.init_points(bits).numpy(),
                                  np.asarray(jcb.init_points(bits)))
    x01 = rng.random((37, 256)).astype(np.float32) ** 2
    padded = x01.copy()
    padded[-1, 64:] = padded[-1, 63]  # the edge padding of a 9,280-weight leaf
    for x in (x01, padded):
        want = np.asarray(jcb.init_points(bits, "quantile", jnp.asarray(x)))
        got = tcb.init_points(bits, "quantile", torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="x01"):
        tcb.init_points(bits, "quantile")
    with pytest.raises(ValueError, match="init mode"):
        tcb.init_points(bits, "kmeans")


def test_quantile_beyond_torch_quantile_limit():
    # torch.quantile refuses more than 2^24 elements; the sort-based one does not
    x = torch.rand(1 << 24 | 5, generator=torch.Generator().manual_seed(0))
    got = tcb.quantile_linear(x, tcb.linspace01(4))
    assert got[0] == x.min() and got[-1] == x.max() and torch.all(got[1:] >= got[:-1])


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("scaling", ["linear", "absmax"])
def test_fake_quant_values_match_jax(bits, scaling):
    rng = np.random.default_rng(bits + 10)
    x = rng.standard_normal((19, 70)).astype(np.float32)  # ragged last bucket
    pts = _points("outside", bits, rng)
    want = np.asarray(jcb.fake_quant(jnp.asarray(x), jnp.asarray(pts), scaling=scaling))
    got = tcb.fake_quant(torch.from_numpy(x), torch.from_numpy(pts), scaling=scaling)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VALUE_ATOL)
    jq = jcb.quantize(jnp.asarray(x), jnp.asarray(pts), scaling=scaling)
    tq = tcb.quantize(torch.from_numpy(x), torch.from_numpy(pts), scaling=scaling)
    np.testing.assert_array_equal(tq.idx.numpy(), np.asarray(jq.idx))
    assert tq.n == jq.n and tq.shape == jq.shape


def test_ste_fake_quant_gradients_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 300)).astype(np.float32)
    pts = _points("unsorted", 4, rng)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(xx, pp):
        return jnp.sum(jcb.ste_fake_quant(xx, pp) * cot)

    jval = np.asarray(jcb.ste_fake_quant(jnp.asarray(x), jnp.asarray(pts)))
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(pts))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = torch.from_numpy(pts).requires_grad_(True)
    out = tcb.ste_fake_quant(tx, tp)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jval, rtol=0, atol=VALUE_ATOL)
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgx))  # identity: the cotangent
    scale = float(np.abs(np.asarray(jgp)).max())
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=0, atol=GRAD_TOL * scale)
    # the value is the hard fake-quant, exactly (q + (x - x) adds a zero)
    assert torch.equal(out.detach(), tcb.fake_quant(tx.detach(), tp.detach()))
