"""The PyTorch port's fake-quant: the plain version of its kernel and
``ops/uniform.py`` against the JAX package's Pallas kernel (interpret mode,
as tests/test_kernels.py runs it) and its jnp pipeline, at f32.

Tolerance: grid levels equal exactly; values within JAX's own 2e-6 (the
two frameworks may round ``q/s * scale + off`` differently by an ulp).

Tests marked ``gpu`` hold the CUDA kernel against its plain version on the
card, bit for bit; they skip where PyTorch sees no card. JAX is imported
inside the CPU tests' fixture, so ``pytest -m gpu`` runs without JAX.
"""

import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.kernels import (
    fake_quant_buckets,
    fake_quant_buckets_reference,
)
from quantized_distillation_tpu_torch.ops import uniform
from quantized_distillation_tpu_torch.ops.bucketing import from_buckets, to_buckets

torch.set_num_threads(2)

ATOL = 2e-6  # TestFakeQuantKernel's tolerance in tests/test_kernels.py


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.kernels.fake_quant import fake_quant_buckets_pallas
    from quantized_distillation_tpu.ops import bucketing
    from quantized_distillation_tpu.ops import uniform as juniform

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, pallas=fake_quant_buckets_pallas, uniform=juniform,
        to_buckets=bucketing.to_buckets,
    )


def _levels_jax(jx, v, bits, scaling):
    return np.asarray(jx.uniform.quantize(jx.jnp.asarray(v), bits, scaling=scaling).levels)


class TestFakeQuantKernelPlain:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    @pytest.mark.parametrize("scaling", ["linear", "absmax"])
    @pytest.mark.parametrize("shape", [(37, 129), (48, 192)])  # ragged tail; not 256-aligned rows
    def test_matches_pallas_interpret_and_jnp(self, jx, bits, scaling, shape):
        rng = np.random.default_rng(bits + 7 * shape[1])
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jx.uniform.fake_quant(jx.jnp.asarray(x), bits, scaling=scaling,
                                                use_pallas=False))
        jb, n = jx.to_buckets(jx.jnp.asarray(x), 256)
        pallas = np.asarray(jx.pallas(jb, bits, scaling=scaling, row_tile=8, interpret=True))
        pallas = pallas.reshape(-1)[:n].reshape(shape)

        xt = torch.from_numpy(x)
        tb, tn = to_buckets(xt, 256)
        got_kernel = from_buckets(fake_quant_buckets(tb, bits, scaling=scaling), tn, shape).numpy()
        got_ops = uniform.fake_quant(xt, bits, scaling=scaling).numpy()
        np.testing.assert_array_equal(got_kernel, got_ops)  # one formula, one device
        for ref in (want, pallas):
            np.testing.assert_allclose(got_kernel, ref, rtol=0, atol=ATOL)
            np.testing.assert_array_equal(_levels_jax(jx, got_kernel, bits, scaling),
                                          _levels_jax(jx, ref, bits, scaling))
        lv = uniform.quantize(xt, bits, scaling=scaling).levels.numpy()
        np.testing.assert_array_equal(lv, _levels_jax(jx, x, bits, scaling))

    @pytest.mark.parametrize("scaling", ["linear", "absmax"])
    def test_degenerate_buckets_come_back_unchanged(self, jx, scaling):
        b = np.concatenate([np.full((2, 256), 3.25, np.float32), np.zeros((2, 256), np.float32)])
        if scaling == "absmax":
            b = b[2:]  # abs-max maps a constant c to the grid's top: only 0 is a fixed point
        got = fake_quant_buckets(torch.from_numpy(b), 4, scaling=scaling).numpy()
        np.testing.assert_array_equal(got, b)
        np.testing.assert_array_equal(
            got, np.asarray(jx.pallas(jx.jnp.asarray(b), 4, scaling=scaling, interpret=True)))

    def test_ste_gradient_is_the_identity(self, jx):
        rng = np.random.default_rng(3)
        x = rng.standard_normal(600).astype(np.float32)

        def loss(v):
            return jx.jnp.sum(jx.jnp.sin(jx.uniform.ste_fake_quant(v, 4, use_pallas=False)))

        g_jax = np.asarray(jx.jax.grad(loss)(jx.jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        q = uniform.ste_fake_quant(xt, 4)
        torch.sin(q).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), g_jax, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(q.detach().numpy(), xt.detach().numpy() + (
            uniform.fake_quant(xt, 4) - xt.detach()).numpy())

    def test_rejects_bad_arguments(self):
        with pytest.raises(ValueError, match="scaling"):
            fake_quant_buckets(torch.zeros(2, 256), 4, scaling="log")
        with pytest.raises(ValueError, match="n_buckets"):
            fake_quant_buckets(torch.zeros(256), 4)


def test_bucketing_helpers_match_jax(jx):
    from quantized_distillation_tpu.ops import bucketing as jb

    from quantized_distillation_tpu_torch.ops import bucketing as tb

    x = np.random.default_rng(2).standard_normal((7, 45)).astype(np.float32)
    for kind in ("linear", "absmax"):
        jbk, n = jb.to_buckets(jx.jnp.asarray(x), 128)
        jsp = jb.compute_scale(jbk, kind)
        tbk, tn = tb.to_buckets(torch.from_numpy(x), 128)
        tsp = tb.compute_scale(tbk, kind)
        x01 = tb.apply_scale(tbk, tsp)
        np.testing.assert_allclose(x01.numpy(), np.asarray(jb.apply_scale(jbk, jsp)),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(tb.invert_scale(x01, tsp).numpy(), np.asarray(jbk),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tb.from_buckets(tbk, tn, x.shape).numpy(), x)
        assert tb.floats_per_bucket(kind) == jb.floats_per_bucket(kind)
    with pytest.raises(ValueError):
        tb.floats_per_bucket("log")


class TestStochasticRounding:
    def test_levels_in_range_and_unbiased(self):
        g = torch.Generator().manual_seed(0)
        x01 = torch.full((200_000,), 0.3)
        for bits in (2, 4):
            q = uniform.quantize_levels_01(x01, bits, stochastic=True, generator=g)
            s = (1 << bits) - 1
            assert int(q.min()) >= 0 and int(q.max()) <= s
            assert set(np.unique(q.numpy())) <= {int(np.floor(0.3 * s)), int(np.ceil(0.3 * s))}
            mean = float(q.double().mean()) / s
            # binomial standard error of the mean: sqrt(p(1-p)/n)/s < 2e-3
            assert abs(mean - 0.3) < 5e-3

    def test_same_seed_same_levels_and_needs_a_generator(self):
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((9, 100)).astype(np.float32))
        a = uniform.fake_quant(x, 4, stochastic=True, generator=torch.Generator().manual_seed(5))
        b = uniform.fake_quant(x, 4, stochastic=True, generator=torch.Generator().manual_seed(5))
        assert torch.equal(a, b)
        assert not torch.equal(a, uniform.fake_quant(x, 4))
        with pytest.raises(ValueError, match="Generator"):
            uniform.fake_quant(x, 4, stochastic=True)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("scaling", ["linear", "absmax"])
@pytest.mark.parametrize("bucket_size", [128, 256, 384])
def test_gpu_fake_quant_bit_exact(cuda, bits, scaling, bucket_size):
    rng = np.random.default_rng(bits)
    b = rng.standard_normal((1003, bucket_size)).astype(np.float32)  # ragged last block
    b[:3] = 1.5  # constant buckets
    b[3:5] = 0.0
    b[5] *= 1e-30  # tiny range
    x = torch.from_numpy(b).to(cuda)
    n0 = fake_quant_buckets.launches
    got = fake_quant_buckets(x, bits, scaling=scaling)
    torch.cuda.synchronize()
    assert fake_quant_buckets.launches == n0 + 1
    assert torch.equal(got, fake_quant_buckets_reference(x, bits, scaling=scaling))


@pytest.mark.gpu
def test_gpu_fake_quant_through_ops_and_rejects(cuda):
    x = torch.randn(300, 77, device=cuda)
    n0 = fake_quant_buckets.launches
    got = uniform.fake_quant(x, 4)
    assert fake_quant_buckets.launches == n0 + 1
    assert torch.equal(got, uniform.fake_quant(x.cpu(), 4).to(cuda))
    with pytest.raises(ValueError, match="bits"):
        fake_quant_buckets(torch.zeros(4, 256, device=cuda), 3)
    with pytest.raises(ValueError, match="multiple"):
        fake_quant_buckets(torch.zeros(4, 200, device=cuda), 4)
    with pytest.raises(ValueError, match="contiguous"):
        fake_quant_buckets(torch.zeros(256, 4, device=cuda).t(), 4)
