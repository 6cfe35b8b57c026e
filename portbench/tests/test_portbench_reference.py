"""The port's CPU path held to the plain reference at tiny sizes: the
quantizers, the forwards and the loss term by term, and whole runs of each
cell (timed path, then the comparison) reading far inside their limits."""

import pytest
import torch

import tiny
from portbench import weights
from portbench.reference import models, quant, train
from quantized_distillation_tpu_torch.config import QuantSpec
from quantized_distillation_tpu_torch.kernels.packed import dequantize_linear, pack_linear
from quantized_distillation_tpu_torch.models import make_lm, make_seq2seq
from quantized_distillation_tpu_torch.train import losses, quantize_tree

SEED = 2**31 + 5


def seq2seq_pair():
    shapes = weights.seq2seq_shapes(67, 16, 16, 2)
    w = weights.make(shapes, SEED, "cpu")
    model = make_seq2seq("student_medium", 67, 67, device="cpu", embed_dim=16, hidden=16,
                         num_layers=2, dropout=0.0)
    weights.load_into(model, w)
    return w, model


def lm_pair():
    w = weights.make(weights.lm_shapes(53, 16, 16, 2), SEED, "cpu")
    model = make_lm("student_medium", 53, device="cpu", embed_dim=16, hidden=16,
                    num_layers=2, dropout=0.0)
    weights.load_into(model, w)
    return w, model


def test_weights_from_seed():
    shapes = weights.seq2seq_shapes(67, 16, 16, 2)
    a, b = weights.make(shapes, 3, "cpu"), weights.make(shapes, 3, "cpu")
    c = weights.make(shapes, 4, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["tgt_embed"], c["tgt_embed"])
    assert (a["generator_bias"] == 0).all()
    assert abs(float(a["decoder.cells.0.wi"].std()) * 32 ** 0.5 - 1) < 0.1


def test_weights_refuse_other_shapes():
    w = weights.make(weights.seq2seq_shapes(67, 16, 16, 1), 1, "cpu")
    _, model = seq2seq_pair()
    with pytest.raises(ValueError):
        weights.load_into(model, w)


@pytest.mark.parametrize("pair", [seq2seq_pair, lm_pair])
def test_training_quantizer_equals_port(pair):
    w, model = pair()
    params = dict(model.named_parameters())
    got = quantize_tree.ste_quantize_tree(params, QuantSpec(bits=4, bucket_size=256))
    want = quant.ste_quantize(w, 4, 256)
    for n in params:
        assert torch.equal(got[n].detach(), want[n].detach()), n


@pytest.mark.parametrize("shape", [(48, 64), (16, 300), (5, 256)])
def test_serving_quantizer_equals_packing(shape):
    w = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(quant.quantize_rows(w, 4), dequantize_linear(pack_linear(w, 4)))


def test_seq2seq_forward_equals_port():
    w, model = seq2seq_pair()
    g = torch.Generator().manual_seed(2)
    src = torch.randint(4, 67, (3, 7), generator=g)
    src_len = torch.tensor([7, 3, 5])
    tgt = torch.randint(4, 67, (3, 6), generator=g)
    with torch.no_grad():
        want = model(src, src_len, tgt)
    got = models.seq2seq_forward(w, src, src_len, tgt, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_lm_forward_equals_port():
    w, model = lm_pair()
    tokens = torch.randint(0, 53, (3, 5), generator=torch.Generator().manual_seed(2))
    carry = model.initial_carry(3)
    with torch.no_grad():
        want, want_carry = model(tokens, carry)
    got, got_carry = models.lm_forward(w, tokens, carry, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_carry[1][1], want_carry[1][1], rtol=1e-5, atol=1e-6)


def test_kd_loss_equals_port():
    g = torch.Generator().manual_seed(3)
    s, t = torch.randn(2, 5, 11, generator=g), torch.randn(2, 5, 11, generator=g)
    labels = torch.randint(0, 11, (2, 5), generator=g)
    mask = (torch.rand(2, 5, generator=g) > 0.3).float()
    from quantized_distillation_tpu_torch.config import DistillSpec

    want = losses.distillation_loss(s, t, labels, DistillSpec(), mask)
    got = train.kd_loss(s, t, labels, mask, 0.7, 5.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("workload", ["nmt-serve-offline", "nmt-kd-train", "lm-kd-train"])
def test_tiny_cell_correct(workload):
    cell = tiny.cell(workload)
    out = tiny.run(cell)
    assert out.failed == 0 and out.attempted > 0
    for name, value, limit in out.checks:
        assert value <= limit / 10, (name, value, limit)
    rate = next(iter(out.rates.values()))
    assert rate > 0


def test_tiny_trace_records_spans():
    cell = tiny.cell("nmt-kd-train")
    out = tiny.run(cell, trace=True)
    assert out.record["units"] == cell.traffic["trace_units"]
    assert len(out.record["spans"]["step"]) == cell.traffic["trace_units"]
    assert out.window_s > 0


@pytest.mark.parametrize("beam", [1, 5])
def test_beam_search_equals_port(beam):
    """The reference's beam search finds the port's hypothesis on the
    port's CPU path in float32 (no rounding apart)."""
    from quantized_distillation_tpu_torch.config import BeamConfig
    from quantized_distillation_tpu_torch.convert import params_to_numpy
    from quantized_distillation_tpu_torch.serve import beam_search_packed, pack_decoder

    from portbench.reference.serve import beam_search, deployed_weights

    w, model = seq2seq_pair()
    dec = pack_decoder(params_to_numpy(model), model.cfg, 4, compute_dtype=torch.float32,
                       device="cpu")
    g = torch.Generator().manual_seed(4)
    src = torch.randint(4, 67, (3, 7), generator=g)
    src_len = torch.tensor([7, 3, 5])
    toks, scores = beam_search_packed(model, dec, src, src_len,
                                      BeamConfig(beam_size=beam, max_len=9), device="cpu")
    wq = deployed_weights(w, 2, 4)
    for r in range(3):
        want = beam_search(wq, src[r:r + 1], src_len[r:r + 1], beam, 9, 2)[0]
        assert torch.equal(toks[r].long(), want), r


def test_every_training_shape_checked():
    """The steps the reference follows hold every shape of the cycle, each
    at least twice (its graph's capture, then a replay), the first up to
    three times."""
    from portbench import traffic
    from portbench.paths.train_kd import _order

    cell = tiny.cell("nmt-kd-train")
    for seed in (1, 2, 3):
        cycle = traffic.pairs(cell.traffic, cell.config["vocab"], seed)
        checked, start = _order(cycle, "seq2seq")
        shapes = [cycle[i]["src"].shape for i in checked]
        assert start == 0 and len(set(checked)) == len(checked)
        assert {b["src"].shape for b in cycle} == set(shapes)
        sent = [b["src"].shape for b in cycle]
        assert shapes[0] == sent[0]
        for s in set(shapes):
            assert shapes.count(s) == min(sent.count(s), 3 if s == sent[0] else 2)
            assert shapes.count(s) >= 2
