"""The LSTM time loops read their per-step inputs from one ``unbind(1)``.

Each loop of the port (``LSTMLanguageModel.forward``, ``Encoder._run``,
``Seq2Seq.decode``, ``run_lstm_tp``, ``Seq2Seq._decode_tp``) takes step t of
its whole-sequence input from ``unbind(1)``, made once before the loop. The
backward of ``unbind`` is one ``stack``; indexing ``x[:, t]`` at every step
left a ``SelectBackward0`` per step, each a zero fill of the whole input and
a full-size add into its gradient. These tests walk the loss's autograd
graph for the nodes, and hold the loss and every gradient bit-equal to a
slice-per-step copy of the loops written here.
"""

import pytest
import torch

from quantized_distillation_tpu_torch.models import make_lm, make_seq2seq
from quantized_distillation_tpu_torch.models.lm import LSTMLanguageModel
from quantized_distillation_tpu_torch.kernels.lstm_cell import lstm_cell
from quantized_distillation_tpu_torch.models import seq2seq
from quantized_distillation_tpu_torch.models.seq2seq import Encoder, Seq2Seq, dropout

torch.set_num_threads(2)

B, T_SRC, T_TGT, VOCAB = 3, 6, 5, 40
# one UnbindBackward0 per loop input: the LM's 2 layers; the student's 2
# encoder layers and its decoder
LOOPS = {"lm": 2, "seq2seq": 3}
# the loops' steps in all: the LM's 2 layers over T_SRC; the student's 2
# encoder layers over T_SRC and its decoder over T_TGT
STEPS = {"lm": 2 * T_SRC, "seq2seq": 2 * T_SRC + T_TGT}


def _model(kind):
    if kind == "lm":
        model = make_lm("student_medium", VOCAB, device="cpu", seed=3, embed_dim=16,
                        hidden=12, dropout=0.25)
    else:
        model = make_seq2seq("student_medium", VOCAB, VOCAB + 7, device="cpu", seed=3,
                             embed_dim=16, hidden=12, dropout=0.25)
    model.requires_grad_(True)
    return model


def _inputs(kind, seed=11):
    g = torch.Generator().manual_seed(seed)
    if kind == "lm":
        tokens = torch.randint(0, VOCAB, (B, T_SRC), generator=g)
        return (tokens,), torch.randint(0, VOCAB, (B, T_SRC), generator=g)
    src = torch.randint(0, VOCAB, (B, T_SRC), generator=g)
    src_len = torch.tensor([T_SRC, 4, 2])
    tgt_in = torch.randint(0, VOCAB + 7, (B, T_TGT), generator=g)
    return (src, src_len, tgt_in), torch.randint(0, VOCAB + 7, (B, T_TGT), generator=g)


def _loss(kind, model, *, tp=False):
    """Seeded train-mode loss (dropout on) → (loss, its graph's node names)."""
    args, target = _inputs(kind)
    gen = torch.Generator().manual_seed(5)
    if tp:
        params = dict(model.named_parameters())
        out = model.forward_tp(params, *args, model_parallel=None, train=True, generator=gen)
    else:
        out = model(*args, train=True, generator=gen)
    logits = out[0] if kind == "lm" else out
    loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1), target.flatten())
    return loss, _graph_nodes(loss)


def _graph_nodes(loss):
    names, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return names


def _grads(model, loss):
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


# The loops as they were: the step's input indexed out of the sequence.

def _sliced_lm_forward(self, tokens, carry=None, *, train=False, generator=None):
    cfg = self.cfg
    x = dropout(self.embed.embedding[tokens], cfg.dropout, train, generator)
    finals = []
    for i in range(cfg.num_layers):
        cell = getattr(self, f"OptimizedLSTMCell_{i}")
        state = carry[i] if carry is not None else (
            x.new_zeros((x.shape[0], cfg.hidden)), x.new_zeros((x.shape[0], cfg.hidden)))
        xw = x @ cell.wi
        hs = []
        for t in range(x.shape[1]):
            state = cell.step(state, xw[:, t])
            hs.append(state[1])
        finals.append(state)
        x = dropout(torch.stack(hs, dim=1), cfg.dropout, train, generator)
    logits = x @ self.embed.embedding.T if self.generator is None else self.generator(x)
    return logits, tuple(finals)


def _sliced_encoder_run(self, cell, x, last, rows):
    c = h = x.new_zeros((x.shape[0], self.width))
    cs, hs = [], []
    for step in range(x.shape[1]):
        c, h = cell((c, h), x[:, step])
        cs.append(c)
        hs.append(h)
    out = torch.stack(hs, dim=1)
    return out, (torch.stack(cs)[last, rows], out[rows, last])


def _sliced_decode(self, state, tgt_in, enc_out, enc_mask, *, train=False, generator=None):
    y_emb = self.tgt_embed[tgt_in]
    outs = []
    for step in range(tgt_in.shape[1]):
        state, (attn_h, _) = self.decoder(
            state, y_emb[:, step], enc_out, enc_mask, train=train, generator=generator
        )
        outs.append(attn_h)
    return state, self.generator(torch.stack(outs, dim=1))


def _sliced(monkeypatch, kind):
    if kind == "lm":
        monkeypatch.setattr(LSTMLanguageModel, "forward", _sliced_lm_forward)
    else:
        monkeypatch.setattr(Encoder, "_run", _sliced_encoder_run)
        monkeypatch.setattr(Seq2Seq, "decode", _sliced_decode)


@pytest.mark.parametrize("tp", [False, True], ids=["forward", "forward_tp_unsplit"])
@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_loop_inputs_unbind_once_and_select_nowhere(kind, tp):
    _, nodes = _loss(kind, _model(kind), tp=tp)
    assert "SelectBackward0" not in nodes
    assert nodes.count("UnbindBackward0") == LOOPS[kind]


@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_loss_and_gradients_equal_the_slice_per_step_loop(kind, monkeypatch):
    model = _model(kind)
    loss, _ = _loss(kind, model)
    grads = _grads(model, loss)
    with monkeypatch.context() as m:
        _sliced(m, kind)
        want_loss, want_nodes = _loss(kind, model)
        want = _grads(model, want_loss)
    # the copy is what the walk above would catch: one select a loop step
    assert want_nodes.count("SelectBackward0") == STEPS[kind]
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want.keys()
    for name in grads:
        assert torch.equal(grads[name], want[name]), name


def test_run_lstm_tp_unsplit_equals_the_lm_loop():
    model = _model("lm")
    loss, _ = _loss("lm", model)
    grads = _grads(model, loss)
    tp_loss, _ = _loss("lm", model, tp=True)
    tp_grads = _grads(model, tp_loss)
    assert torch.equal(tp_loss, loss)
    for name in grads:
        assert torch.equal(tp_grads[name], grads[name]), name


def test_the_cell_reads_each_step_as_a_view_of_the_lm_product(monkeypatch):
    """The cell gets step t of the layer's [B, T, 4W] product as a strided
    view, as the slice gave it: no copy of the step (the kernel reads it by
    its row stride)."""
    seen = []

    def recording(hw, bh, xw, c):
        seen.append((xw.untyped_storage().data_ptr(), xw.storage_offset(), xw.stride()))
        return lstm_cell(hw, bh, xw, c)

    monkeypatch.setattr(seq2seq, "lstm_cell", recording)
    model = _model("lm")
    _loss("lm", model)
    width = 4 * model.cfg.hidden
    assert len(seen) == STEPS["lm"]
    for layer in (seen[:T_SRC], seen[T_SRC:]):
        assert len({storage for storage, _, _ in layer}) == 1
        assert [offset for _, offset, _ in layer] == [t * width for t in range(T_SRC)]
        assert all(stride == (T_SRC * width, 1) for _, _, stride in layer)
