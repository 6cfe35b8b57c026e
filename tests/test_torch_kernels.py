"""The PyTorch port's three serving kernels, and the LUT variants of the
first two (a matrix packed with a learned codebook).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels run in interpret mode (as
tests/test_kernels.py runs them) and against its jnp references, at f32
compute: values and lse within 1e-4 (summation order differs), indices and
combine outputs exactly equal.

Tests marked ``gpu`` hold each CUDA kernel against its plain version on the
card; they skip where PyTorch sees no card. JAX is imported inside the CPU
tests' fixture, so ``pytest -m gpu`` runs on a machine without JAX.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.kernels import (
    beam_combine_topk,
    beam_combine_topk_reference,
    dequant_matmul,
    dequant_matmul_reference,
    dequant_matmul_topk,
    dequant_matmul_topk_reference,
    dequantize_linear,
    pack_linear,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and what the comparisons need of JAX."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu import kernels
    from quantized_distillation_tpu.kernels.beam_combine import beam_combine_topk

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, pack_linear=kernels.pack_linear,
        dequant_matmul=kernels.dequant_matmul,
        dequant_matmul_reference=kernels.dequant_matmul_reference,
        dequant_matmul_topk=kernels.dequant_matmul_topk,
        dequant_matmul_topk_reference=kernels.dequant_matmul_topk_reference,
        beam_combine_topk=beam_combine_topk,
    )


def _pair(jx, w, bits, bias=None, points=None, **kw):
    """The same weights (and codebook) packed by both packages."""
    jb = None if bias is None else jx.jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    jpts = None if points is None else jx.jnp.asarray(points)
    tpts = None if points is None else torch.from_numpy(points)
    return (
        jx.pack_linear(jx.jnp.asarray(w), bits, bias=jb, points=jpts, **kw),
        pack_linear(torch.from_numpy(w), bits, bias=tb, points=tpts, **kw),
    )


def _points(rng, bits):
    """A trained-looking codebook: out of order, partly outside [0, 1]."""
    return rng.uniform(-0.1, 1.1, 1 << bits).astype(np.float32)


def _ties_cand(rng, b=16, n=25):
    """Beam-combine candidates with NEG_INF blocks (finished beams) and
    repeated values, as TestBeamCombineKernel makes them."""
    cand = rng.standard_normal((b, n)).astype(np.float32) * 10
    cand[rng.random((b, n)) < 0.35] = -1e9
    cand[:, 3] = cand[:, 7]  # an exact tie in every row
    tok = rng.integers(0, 32000, (b, n)).astype(np.int32)
    return cand, tok


class TestDequantMatmulPlain:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_matches_pallas_interpret_and_reference(self, jx, bits):
        rng = np.random.default_rng(bits)
        w = rng.standard_normal((64, 512)).astype(np.float32)
        x = rng.standard_normal((9, 64)).astype(np.float32)
        jp, tp = _pair(jx, w, bits)
        pal = jx.dequant_matmul(jx.jnp.asarray(x), jp, compute_dtype=jx.jnp.float32, interpret=True)
        ref = jx.dequant_matmul_reference(jx.jnp.asarray(x), jp)
        got = dequant_matmul(torch.from_numpy(x), tp, compute_dtype=torch.float32)
        assert got.shape == (9, 512) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("store_bits", [None, 8])
    def test_ragged_n_odd_m_with_bias(self, jx, store_bits):
        rng = np.random.default_rng(1)
        w = rng.standard_normal((40, 300)).astype(np.float32)
        bias = rng.standard_normal(300).astype(np.float32)
        x = rng.standard_normal((5, 40)).astype(np.float32)
        jp, tp = _pair(jx, w, 4, bias, store_bits=store_bits)
        pal = jx.dequant_matmul(jx.jnp.asarray(x), jp, compute_dtype=jx.jnp.float32, interpret=True)
        got = dequant_matmul(torch.from_numpy(x), tp, compute_dtype=torch.float32)
        assert got.shape == (5, 300)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-4, atol=1e-4)

    def test_bf16_compute_matches_jax_reference(self, jx):
        rng = np.random.default_rng(2)
        w = rng.standard_normal((64, 256)).astype(np.float32)
        x = rng.standard_normal((8, 64)).astype(np.float32)
        jp, tp = _pair(jx, w, 4)
        ref = np.asarray(jx.dequant_matmul_reference(jx.jnp.asarray(x), jp, compute_dtype=jx.jnp.bfloat16))
        got = dequant_matmul(torch.from_numpy(x), tp, compute_dtype=torch.bfloat16).numpy()
        # both round the operands to bf16 and sum the exact products in f32
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


class TestFusedTopKPlain:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_matches_pallas_interpret_and_reference(self, jx, bits):
        rng = np.random.default_rng(10 + bits)
        w = rng.standard_normal((64, 1024)).astype(np.float32)
        x = rng.standard_normal((9, 64)).astype(np.float32)
        bias = rng.standard_normal(1024).astype(np.float32)
        jp, tp = _pair(jx, w, bits, bias)
        pv, pi, plse = jx.dequant_matmul_topk(
            jx.jnp.asarray(x), jp, 5, compute_dtype=jx.jnp.float32, interpret=True
        )
        rv, ri, rlse = jx.dequant_matmul_topk_reference(jx.jnp.asarray(x), jp, 5)
        v, i, lse = dequant_matmul_topk(torch.from_numpy(x), tp, 5, compute_dtype=torch.float32)
        assert v.shape == (9, 5) and i.dtype == torch.int32 and lse.shape == (9, 1)
        for jv, ji, jl in ((pv, pi, plse), (rv, ri, rlse)):
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-4)

    def test_tied_logits_keep_lax_top_k_order(self, jx):
        # zero weights make the logits the bias exactly; the bias is full of
        # ties, some of them across the padded edge
        rng = np.random.default_rng(4)
        bias = rng.integers(0, 4, 700).astype(np.float32)
        w = np.zeros((16, 700), np.float32)
        x = rng.standard_normal((6, 16)).astype(np.float32)
        jp, tp = _pair(jx, w, 4, bias)
        rv, ri, rlse = jx.dequant_matmul_topk_reference(jx.jnp.asarray(x), jp, 8)
        v, i, lse = dequant_matmul_topk(torch.from_numpy(x), tp, 8, compute_dtype=torch.float32)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), atol=1e-4)

    @pytest.mark.parametrize("lut", [False, True])
    @pytest.mark.parametrize("k", [1, 8])
    def test_ragged_shape_matches_pallas_interpret(self, jx, lut, k):
        # M = 1, K = 77 (not a multiple of 16), N = 700 (not of 64): the shape
        # the kernel takes through its element-wise copies and masked tiles
        rng = np.random.default_rng(60 + k + lut)
        w = rng.standard_normal((77, 700)).astype(np.float32)
        bias = rng.standard_normal(700).astype(np.float32)
        x = rng.standard_normal((1, 77)).astype(np.float32)
        kw = dict(points=_points(rng, 4), lut_mode="exact", max_group=2) if lut else {}
        jp, tp = _pair(jx, w, 4, bias, **kw)
        pv, pi, plse = jx.dequant_matmul_topk(
            jx.jnp.asarray(x), jp, k, compute_dtype=jx.jnp.float32, interpret=True, slots=8
        )
        rv, ri, rlse = jx.dequant_matmul_topk_reference(jx.jnp.asarray(x), jp, k)
        v, i, lse = dequant_matmul_topk(torch.from_numpy(x), tp, k, compute_dtype=torch.float32)
        assert v.shape == (1, k) and int(i.max()) < 700
        for jv, ji, jl in ((pv, pi, plse), (rv, ri, rlse)):
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-4)

    def test_certificate_is_all_ones(self, jx):
        rng = np.random.default_rng(5)
        _, tp = _pair(jx, rng.standard_normal((16, 256)).astype(np.float32), 4)
        out = dequant_matmul_topk(torch.ones(3, 16), tp, 4, certify=True)
        assert len(out) == 4 and out[3].dtype == torch.int32 and bool((out[3] == 1).all())

    def test_rejects_k_too_large(self, jx):
        _, tp = _pair(jx, np.ones((16, 256), np.float32), 4)
        with pytest.raises(ValueError):
            dequant_matmul_topk(torch.ones(2, 16), tp, 9)


class TestLUTPlain:
    """The LUT variants' plain versions against the JAX package's codebook
    kernels (``_codebook_kernel`` and the ``pts_ref`` branch of
    ``_topk_kernel``) in interpret mode and its jnp references."""

    @pytest.mark.parametrize("bits", [2, 4, 8])
    @pytest.mark.parametrize("n", [512, 300])  # 300: N not a multiple of the group width
    def test_dequant_matmul_lut_matches_pallas_interpret(self, jx, bits, n):
        rng = np.random.default_rng(20 + bits)
        w = rng.standard_normal((64, n)).astype(np.float32)
        bias = rng.standard_normal(n).astype(np.float32)
        x = rng.standard_normal((9, 64)).astype(np.float32)
        pts = _points(rng, bits)
        jp, tp = _pair(jx, w, bits, bias, points=pts, lut_mode="exact")
        assert tp.points is not None
        pal = jx.dequant_matmul(jx.jnp.asarray(x), jp, compute_dtype=jx.jnp.float32, interpret=True)
        ref = jx.dequant_matmul_reference(jx.jnp.asarray(x), jp)
        got = dequant_matmul(torch.from_numpy(x), tp, compute_dtype=torch.float32)
        assert got.shape == (9, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("bits", [2, 4, 8])
    @pytest.mark.parametrize("n", [1024, 700])
    def test_topk_lut_matches_pallas_interpret(self, jx, bits, n):
        rng = np.random.default_rng(30 + bits)
        w = rng.standard_normal((64, n)).astype(np.float32)
        bias = rng.standard_normal(n).astype(np.float32)
        x = rng.standard_normal((9, 64)).astype(np.float32)
        pts = _points(rng, bits)
        jp, tp = _pair(jx, w, bits, bias, points=pts, lut_mode="exact", max_group=2)
        assert tp.n_padded > n or n == 1024  # padded columns carry no -1e9 bias
        # slots=8 >= k: the TPU kernel keeps enough survivors to be exact
        pv, pi, plse = jx.dequant_matmul_topk(
            jx.jnp.asarray(x), jp, 5, compute_dtype=jx.jnp.float32, interpret=True, slots=8
        )
        rv, ri, rlse = jx.dequant_matmul_topk_reference(jx.jnp.asarray(x), jp, 5)
        v, i, lse = dequant_matmul_topk(torch.from_numpy(x), tp, 5, compute_dtype=torch.float32)
        assert int(i.max()) < n
        for jv, ji, jl in ((pv, pi, plse), (rv, ri, rlse)):
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-4)

    def test_bf16_lut_matches_jax_reference(self, jx):
        rng = np.random.default_rng(6)
        w = rng.standard_normal((64, 256)).astype(np.float32)
        x = rng.standard_normal((8, 64)).astype(np.float32)
        jp, tp = _pair(jx, w, 4, points=_points(rng, 4), lut_mode="exact")
        ref = np.asarray(jx.dequant_matmul_reference(jx.jnp.asarray(x), jp,
                                                     compute_dtype=jx.jnp.bfloat16))
        got = dequant_matmul(torch.from_numpy(x), tp, compute_dtype=torch.bfloat16).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    def test_plain_versions_count_no_launch_and_check_points(self, jx):
        rng = np.random.default_rng(7)
        _, tp = _pair(jx, rng.standard_normal((16, 256)).astype(np.float32), 4,
                      points=_points(rng, 4), lut_mode="exact")
        counts = (dequant_matmul.launches_lut, dequant_matmul_topk.launches_lut)
        dequant_matmul(torch.ones(2, 16), tp)
        dequant_matmul_topk(torch.ones(2, 16), tp, 3)
        assert (dequant_matmul.launches_lut, dequant_matmul_topk.launches_lut) == counts
        from quantized_distillation_tpu_torch.kernels.dequant_matmul import check_operands

        bad = dataclasses.replace(tp, points=tp.points[:8])
        with pytest.raises(ValueError, match="points"):
            check_operands(torch.ones(2, 16), bad, torch.float32)
        with pytest.raises(ValueError, match="points"):
            check_operands(torch.ones(2, 16), dataclasses.replace(tp, points=tp.points.double()),
                           torch.float32)


class TestDequantMatmulWrapper:
    """What the wrapper checks before a launch, on the CPU."""

    def test_alignment_check_raises_on_misaligned_packed_bytes(self):
        from quantized_distillation_tpu_torch.kernels.dequant_matmul import ALIGN, check_alignment

        p = pack_linear(torch.randn(16, 256), 4)
        check_alignment(p)  # pack_linear's tensors are fresh allocations
        buf = torch.zeros(p.packed.numel() + ALIGN, dtype=torch.uint8)
        for shift in (1, 4, 8):
            view = buf[shift:shift + p.packed.numel()].view(p.packed.shape)
            with pytest.raises(ValueError, match="aligned"):
                check_alignment(dataclasses.replace(p, packed=view))
        aligned = buf[ALIGN:ALIGN + p.packed.numel()].view(p.packed.shape)
        check_alignment(dataclasses.replace(p, packed=aligned))

    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_plain_path_takes_any_alignment_and_k(self, bits):
        # the CPU path runs the plain version whatever the alignment; x with
        # K = 77 is what the kernel copies element by element at bf16
        rng = np.random.default_rng(bits)
        w = torch.from_numpy(rng.standard_normal((77, 300)).astype(np.float32))
        p = pack_linear(w, bits, bias=torch.ones(300))
        buf = torch.zeros(p.packed.numel() + 1, dtype=torch.uint8)
        view = buf[1:].view(p.packed.shape)
        view.copy_(p.packed)
        q = dataclasses.replace(p, packed=view)
        x = torch.from_numpy(rng.standard_normal((5, 77)).astype(np.float32))
        for cd in (torch.float32, torch.bfloat16):
            torch.testing.assert_close(dequant_matmul(x, q, compute_dtype=cd),
                                       dequant_matmul_reference(x, p, compute_dtype=cd))

    @pytest.mark.parametrize("preset", ["tiles", "ablate"])
    def test_sweep_edits_each_match_the_sources_once(self, preset):
        # the sweep builds its variants by text edits of csrc/: each must
        # still find exactly one place to change
        from quantized_distillation_tpu_torch.kernels import _build
        from quantized_distillation_tpu_torch.kernels.dequant_matmul_sweep import PRESETS

        for name, edits in PRESETS[preset].items():
            for fname, old, _ in edits:
                assert (_build.CSRC / fname).read_text().count(old) == 1, (name, fname, old)

    @pytest.mark.parametrize("preset", ["tiles", "ablate", "count"])
    def test_topk_sweep_edits_each_match_the_sources_once(self, preset):
        from quantized_distillation_tpu_torch.kernels import _build
        from quantized_distillation_tpu_torch.kernels.topk_fused_sweep import PRESETS

        for name, edits in PRESETS[preset].items():
            for fname, old, _ in edits:
                assert (_build.CSRC / fname).read_text().count(old) == 1, (name, fname, old)


class TestBeamCombinePlain:
    def test_matches_pallas_interpret_and_lax_top_k_with_ties(self, jx):
        rng = np.random.default_rng(11)
        for _ in range(10):
            cand, tok = _ties_cand(rng)
            v0, p0 = jx.jax.lax.top_k(jx.jnp.asarray(cand), 5)
            t0 = jx.jnp.take_along_axis(jx.jnp.asarray(tok), p0, axis=1)
            v1, p1, t1 = jx.beam_combine_topk(jx.jnp.asarray(cand), jx.jnp.asarray(tok), 5, interpret=True)
            v, p, t = beam_combine_topk(torch.from_numpy(cand), torch.from_numpy(tok), 5)
            assert p.dtype == torch.int32 and t.dtype == torch.int32
            for jv, jpos, jt in ((v0, p0, t0), (v1, p1, t1)):
                np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
                np.testing.assert_array_equal(p.numpy(), np.asarray(jpos))
                np.testing.assert_array_equal(t.numpy(), np.asarray(jt))

    def test_wide_rows_and_infinities_match_lax_top_k(self, jx):
        rng = np.random.default_rng(2)
        cand = rng.standard_normal((4, 200)).astype(np.float32)
        cand[:, ::3] = -np.inf
        tok = rng.integers(0, 99, (4, 200)).astype(np.int32)
        v0, p0 = jx.jax.lax.top_k(jx.jnp.asarray(cand), 7)
        v, p, _ = beam_combine_topk(torch.from_numpy(cand), torch.from_numpy(tok), 7)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v0))
        np.testing.assert_array_equal(p.numpy(), np.asarray(p0))

    def test_rejects_k_above_n(self, jx):
        with pytest.raises(ValueError):
            beam_combine_topk(torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32), 4)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _packed_cuda(rng, k, n, bits, bias=True, **kw):
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) if bias else None
    return pack_linear(w, bits, bias=b, **kw).to("cuda")


# (M, K, N): the decode step's three matrices, then shapes that between them
# take every M in {1, 63, 64, 65, 1280}, K in {8, 77, 200, 512, 768} (77 leaves
# bf16 and f32 rows off 16-byte alignment) and N in {31, 256, 700, 1024}
DM_SHAPES = [
    (1280, 768, 1024), (1280, 512, 1024), (1280, 512, 256),
    (77, 200, 700), (1, 8, 31), (63, 77, 256), (64, 200, 700), (65, 512, 1024),
    (1280, 77, 31), (63, 768, 700), (1, 200, 1024), (65, 8, 256),
]


def _check_dequant_matmul(cuda, rng, shape, bits, cd, lut):
    """The kernel against its plain version for x f32 and bf16, bias set and
    unset. f32 compute: rtol = atol = 1e-4. bf16 compute on the tensor cores:
    both round the operands to bf16 and the products are exact in f32, so
    only the f32 summation order differs; the same 1e-4 holds."""
    m, k, n = shape
    pts = torch.from_numpy(_points(rng, bits)) if lut else None
    for bias in (True, False):
        p = _packed_cuda(rng, k, n, bits, bias=bias, points=pts)
        assert (p.points is not None) == lut
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, xdt)
            n0, l0 = dequant_matmul.launches, dequant_matmul.launches_lut
            got = dequant_matmul(x, p, compute_dtype=cd)
            torch.cuda.synchronize()
            counts = (dequant_matmul.launches, dequant_matmul.launches_lut)
            assert counts == ((n0, l0 + 1) if lut else (n0 + 1, l0))
            want = dequant_matmul_reference(x, p, compute_dtype=cd)
            assert got.shape == (m, n)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DM_SHAPES)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_gpu_dequant_matmul_matches_plain(cuda, shape, bits, cd):
    _check_dequant_matmul(cuda, np.random.default_rng(bits), shape, bits, cd, lut=False)


@pytest.mark.gpu
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_gpu_topk_fused_matches_plain(cuda, cd):
    rng = np.random.default_rng(3)
    p = _packed_cuda(rng, 256, 5000, 4, store_bits=8)
    x = torch.from_numpy(rng.standard_normal((130, 256)).astype(np.float32)).to(cuda)
    n0 = dequant_matmul_topk.launches
    v, i, lse = dequant_matmul_topk(x, p, 5, compute_dtype=cd)
    torch.cuda.synchronize()
    assert dequant_matmul_topk.launches == n0 + 1
    rv, ri, rlse = dequant_matmul_topk_reference(x, p, 5, compute_dtype=cd)
    torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    assert torch.equal(i, ri)


@pytest.mark.gpu
def test_gpu_topk_fused_ties_exact(cuda):
    rng = np.random.default_rng(4)
    bias = torch.from_numpy(rng.integers(0, 4, 3000).astype(np.float32))
    p = pack_linear(torch.zeros(32, 3000), 4, bias=bias).to(cuda)
    x = torch.randn(70, 32, device=cuda)
    got = dequant_matmul_topk(x, p, 8, compute_dtype=torch.float32)
    want = dequant_matmul_topk_reference(x, p, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_gpu_beam_combine_bit_exact(cuda):
    rng = np.random.default_rng(11)
    for n in (25, 128):
        cand, tok = _ties_cand(rng, b=300, n=n)
        cand[0, :] = -np.inf  # a row of infinities, which a sentinel would not survive
        c, t = torch.from_numpy(cand).to(cuda), torch.from_numpy(tok).to(cuda)
        n0 = beam_combine_topk.launches
        got = beam_combine_topk(c, t, 5)
        torch.cuda.synchronize()
        assert beam_combine_topk.launches == n0 + 1
        want = beam_combine_topk_reference(c, t, 5)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DM_SHAPES)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_gpu_dequant_matmul_lut_matches_plain(cuda, shape, bits, cd):
    _check_dequant_matmul(cuda, np.random.default_rng(40 + bits), shape, bits, cd, lut=True)


@pytest.mark.gpu
def test_gpu_dequant_matmul_plan(cuda):
    """The tile plans the decode step gets: two warpgroups on 256 rows for
    the lstm matrices, one on 64 rows for attn_out, 80 blocks each; f32
    compute keeps the CUDA-core kernel's 64 x 64 tiles."""
    from quantized_distillation_tpu_torch.kernels import dequant_matmul_plan

    rng = np.random.default_rng(0)
    for (k, n), rows in (((768, 1024), 256), ((512, 1024), 256), ((512, 256), 64)):
        p = _packed_cuda(rng, k, n, 4)
        x = torch.zeros(1280, k, device=cuda, dtype=torch.bfloat16)
        plan = dequant_matmul_plan(x, p)
        assert (plan["BM"], plan["BN"]) == (rows, 64)
        assert plan["blocks"] == (1280 // rows) * (n // 64) and plan["blocks_per_sm"] >= 1
        f32 = dequant_matmul_plan(x, p, compute_dtype=torch.float32)
        assert (f32["BM"], f32["BN"], f32["smem_bytes"]) == (64, 64, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_gpu_topk_fused_lut_matches_plain(cuda, bits, cd):
    # N = 5000 pads to 6144 with edge-padded weights and no -1e9 bias: the
    # kernel itself keeps the padding out
    rng = np.random.default_rng(50 + bits)
    pts = torch.from_numpy(_points(rng, bits))
    p = _packed_cuda(rng, 256, 5000, bits, points=pts, lut_mode="exact", max_group=8)
    x = torch.from_numpy(rng.standard_normal((130, 256)).astype(np.float32)).to(cuda)
    n0, l0 = dequant_matmul_topk.launches, dequant_matmul_topk.launches_lut
    v, i, lse = dequant_matmul_topk(x, p, 5, compute_dtype=cd)
    torch.cuda.synchronize()
    assert (dequant_matmul_topk.launches, dequant_matmul_topk.launches_lut) == (n0, l0 + 1)
    rv, ri, rlse = dequant_matmul_topk_reference(x, p, 5, compute_dtype=cd)
    torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    assert int(i.max()) < 5000
    if cd == torch.float32:
        assert torch.equal(i, ri)


# (M, K, N, k) of the bf16 generator checks: the serving shapes (uniform
# N = 32768, codebook N = 32000), then shapes that between them take every M
# in {1, 63, 65, 130, 1280}, K in {8, 77, 256, 512}, N in {31, 700, 5000,
# 32000, 32768} and k in {1, 5, 8}; K = 2048 leaves x too large to stay
# resident (the streamed-x instance)
TOPK_SHAPES = [
    (1280, 256, 32768, 5), (1280, 256, 32000, 5), (1, 8, 31, 1), (63, 77, 700, 8),
    (65, 512, 5000, 5), (130, 256, 700, 1), (1280, 77, 31, 8), (63, 512, 32000, 1),
    (130, 8, 5000, 8), (1, 256, 32768, 5), (65, 2048, 700, 5),
]


def _topk_band_ok(v, i, rv, ri):
    """Index lists equal, except in rows whose values all lie within the
    bf16 tie band (4 bf16 ulps of the row's largest |value|), as
    chip_smoke.py's check_topk_indices allows."""
    rows_equal = (i == ri).all(dim=1)
    band = 4 * 2.0 ** -8 * rv.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    return bool((rows_equal | ((v - rv).abs() <= band).all(dim=1)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TOPK_SHAPES)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("lut", [False, True])
def test_gpu_topk_fused_bf16_matches_plain(cuda, shape, bits, lut):
    """The tensor-core generator against its plain version, x f32 and bf16:
    both round the operands to bf16 and the products are exact in f32, so
    only the f32 summation order differs: values and lse at rtol = atol =
    1e-4, indices equal up to the bf16 tie band, none at or past N."""
    m, k, n, k_top = shape
    rng = np.random.default_rng(m + k + n + bits + lut)
    kw = dict(points=torch.from_numpy(_points(rng, bits)), lut_mode="exact", max_group=16) if lut else {}
    p = _packed_cuda(rng, k, n, bits, **kw)
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, xdt)
        counts = (dequant_matmul_topk.launches, dequant_matmul_topk.launches_lut)
        v, i, lse = dequant_matmul_topk(x, p, k_top, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n0, l0 = counts
        assert (dequant_matmul_topk.launches, dequant_matmul_topk.launches_lut) == (
            (n0, l0 + 1) if lut else (n0 + 1, l0))
        rv, ri, rlse = dequant_matmul_topk_reference(x, p, k_top, compute_dtype=torch.bfloat16)
        assert v.shape == (m, k_top) and lse.shape == (m, 1)
        torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
        assert _topk_band_ok(v, i, rv, ri)
        assert int(i.max()) < n and int(i.min()) >= 0


@pytest.mark.gpu
@pytest.mark.parametrize("lut", [False, True])
def test_gpu_topk_fused_bf16_ties_exact(cuda, lut):
    # zero weights make the logits the bias exactly at bf16 too (a codebook
    # needs an exact 0 among its points for that): ties must go to the
    # lower index, bit for bit
    rng = np.random.default_rng(5)
    bias = torch.from_numpy(rng.integers(0, 4, 3000).astype(np.float32))
    pts = _points(rng, 4)
    pts[3] = 0.0
    kw = dict(points=torch.from_numpy(pts), lut_mode="exact") if lut else {}
    p = pack_linear(torch.zeros(32, 3000), 4, bias=bias, **kw).to(cuda)
    assert not dequantize_linear(p).any()
    x = torch.from_numpy(rng.standard_normal((70, 32)).astype(np.float32)).to(cuda)
    got = dequant_matmul_topk(x, p, 8, compute_dtype=torch.bfloat16)
    want = dequant_matmul_topk_reference(x, p, 8, compute_dtype=torch.bfloat16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)


def _adversarial_bias(pattern, n, rng):
    """Bias streams built against the selection's filter: every column a
    record, every column worse than the first, one value everywhere (with
    zero weights: ties across lanes, quads, tiles and splits), distinct
    integers with the row's best in the last column."""
    if pattern == "ascending":
        return np.arange(n, dtype=np.float32)
    if pattern == "descending":
        return -np.arange(n, dtype=np.float32)
    if pattern == "equal":
        return np.full(n, 0.5, np.float32)
    bias = rng.permutation(n).astype(np.float32)
    bias[n - 1] = n + 100.0
    return bias


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["ascending", "descending", "equal", "best_last"])
@pytest.mark.parametrize("shape", [(1280, 256, 32768), (130, 256, 5000), (65, 2048, 700)])
@pytest.mark.parametrize("lut", [False, True])
def test_gpu_topk_fused_bf16_adversarial_exact(cuda, pattern, shape, lut):
    """The tensor-core generator on streams that defeat a threshold, at the
    serving shape, a ragged N (not a multiple of any vocab tile) and K =
    2048 (the streamed-x instance), k = 1, 5 and 8. The bias sets the order
    (gaps of 1 or more) and x @ W adds at most ~0.3, so the order is exact
    in bf16: indices equal, values and lse at rtol = atol = 1e-4."""
    m, k, n = shape
    rng = np.random.default_rng(m + k + n + lut + len(pattern))
    pts = _points(rng, 4)
    pts[3] = 0.0  # zero weights dequantize to exactly 0 through the codebook too
    kw = dict(points=torch.from_numpy(pts), lut_mode="exact", max_group=16) if lut else {}
    w = np.zeros((k, n), np.float32) if pattern == "equal" else rng.standard_normal((k, n))
    p = pack_linear(torch.from_numpy(w.astype(np.float32)), 4,
                    bias=torch.from_numpy(_adversarial_bias(pattern, n, rng)), **kw).to(cuda)
    if pattern == "equal":
        assert not dequantize_linear(p).any()
    x = torch.from_numpy((rng.standard_normal((m, k)) * 0.05 / np.sqrt(k)).astype(np.float32)).to(cuda)
    for k_top in (1, 5, 8):
        counts = (dequant_matmul_topk.launches, dequant_matmul_topk.launches_lut)
        v, i, lse = dequant_matmul_topk(x, p, k_top, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert (dequant_matmul_topk.launches, dequant_matmul_topk.launches_lut) == (
            (counts[0], counts[1] + 1) if lut else (counts[0] + 1, counts[1]))
        rv, ri, rlse = dequant_matmul_topk_reference(x, p, k_top, compute_dtype=torch.bfloat16)
        assert torch.equal(i, ri), (k_top, pattern)
        torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_gpu_topk_fused_plan(cuda):
    """The serving plan: x resident, about one wave of blocks over the SMs;
    and every plan, at any K, bits, codebook or x type, fits in 227 KB of
    shared memory and launches at least one block per SM."""
    from quantized_distillation_tpu_torch.kernels import dequant_matmul_topk_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    p = _packed_cuda(rng, 256, 32768, 4)
    plan = dequant_matmul_topk_plan(torch.zeros(1280, 256, device=cuda), p)
    assert plan["x_resident"] == 1 and plan["BN"] % 64 == 0
    assert plan["blocks"] == -(-1280 // plan["BM"]) * plan["splits"]
    assert sms * plan["blocks_per_sm"] // 2 < plan["blocks"] <= sms * plan["blocks_per_sm"]
    assert plan["splits"] * plan["tiles_per_split"] >= 32768 // plan["BN"]
    f32 = dequant_matmul_topk_plan(torch.zeros(1280, 256, device=cuda), p, compute_dtype=torch.float32)
    assert (f32["BM"], f32["BN"], f32["smem_bytes"], f32["x_resident"]) == (64, 64, 0, 0)
    for k in (8, 77, 256, 512, 1024, 1536, 2048, 4096):
        for bits in (2, 4, 8):
            for pts in (None, torch.from_numpy(_points(rng, bits))):
                q = _packed_cuda(rng, k, 700, bits, points=pts)
                for xdt in (torch.float32, torch.bfloat16):
                    for m in (1, 1280):
                        pl = dequant_matmul_topk_plan(torch.zeros(m, k, device=cuda, dtype=xdt), q)
                        assert pl["smem_bytes"] <= 232448 and pl["blocks_per_sm"] >= 1, (k, bits, pl)
                        assert pl["x_resident"] == (k <= 1536), (k, pl)
