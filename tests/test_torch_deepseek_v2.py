"""The port's DeepSeek-V2 share (``models/deepseek_v2.py``), its grouped
expert matmul (``kernels/grouped_matmul.py``) and the device counters
(``utils.tracing``) against the benchmark's plain reference
(``portbench/reference/deepseek_v2.py``) and against plain loops, at tiny
widths on the CPU.

Tolerances (f32 on the CPU): the model's logits and one KD step's loss
and gradients rtol = atol = 2e-5 (the port's attention is
``scaled_dot_product_attention`` and its expert sums ``index_add`` in
another order than the reference's explicit softmax and per-expert loop;
at these widths the orders part by a few ulps, ~2e-6 of logits of ~3);
the grouped matmul's CPU path against a per-expert loop of the same
products exactly (the same products on the same rows), its gradients
rtol = atol = 1e-5 (sums of the same terms in another order); YaRN's
frequencies rtol 1e-6 against the closed form in float64 (f32 rounding);
the expert-share sum rtol = atol = 1e-5 (eight partial sums in another
order than one).

Tests marked ``gpu`` hold the CUDA kernels against the per-expert loop
at the benchmark cell's widths (2048 → 1408 and back) and show the device
counters moving on each replay of a captured graph; they skip where
PyTorch sees no card.
"""

import copy
import math

import pytest
import torch

from portbench.reference import deepseek_v2 as ref
from portbench.reference.numerics import no_tf32
from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.kernels import grouped_matmul, launch_counts
from quantized_distillation_tpu_torch.models import DeepseekV2Config, make_deepseek_v2
from quantized_distillation_tpu_torch.models.deepseek_v2 import (
    MoE,
    apply_rope,
    rope_mscale,
    softmax_scale,
    yarn_inv_freq,
)
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    lm_task,
    make_train_step,
)
from quantized_distillation_tpu_torch.utils.tracing import (
    device_count,
    device_counts,
    reset_device_counts,
)

torch.set_num_threads(2)

ROPE = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 4096, "type": "yarn"}
TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, n_routed_experts=16, n_shared_experts=2,
            num_experts_per_tok=3, first_k_dense_replace=1, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, rms_norm_eps=1e-6,
            rope_theta=10000, rope_scaling=ROPE, routed_scaling_factor=1.0,
            norm_topk_prob=False)
TOL = dict(rtol=2e-5, atol=2e-5)


def _model(first=4, held=4, seed=3, counters=None, **kw):
    return make_deepseek_v2(dict(TINY, **kw), first_expert=first, n_held=held, seed=seed,
                            counters=counters or f"moe.held{held}", device="cpu")


def _weights(m):
    return {n: p.detach().clone() for n, p in m.named_parameters()}


def _tokens(seed=0, rows=2, length=12):
    return torch.randint(0, TINY["vocab_size"], (rows, length),
                         generator=torch.Generator().manual_seed(seed))


# --------------------------------------------------------------- the model


@pytest.mark.parametrize("first,held", [(4, 4), (0, 16), (12, 4)])
def test_forward_equals_reference(first, held):
    m = _model(first, held)
    w = _weights(m)
    assert {n: tuple(t.shape) for n, t in w.items()} == ref.shapes(TINY, held)
    toks = _tokens()
    logits, carry = m(toks)
    assert carry is None and logits.shape == (2, 12, TINY["vocab_size"])
    torch.testing.assert_close(logits, ref.forward(w, toks, TINY, first, held), **TOL)
    # on substituted weights, as the trainer runs the student
    w2 = {n: t * 1.01 for n, t in w.items()}
    got, _ = m.forward_with(w2, toks)
    torch.testing.assert_close(got, ref.forward(w2, toks, TINY, first, held), **TOL)


def test_yarn_closed_form_and_scales():
    """The catalog's values: θ 10000, 64 rotary dims, factor 40, original
    length 4096, β 32 / 1, mscale = mscale_all_dim = 0.707."""
    d, base = 64, 10000.0

    def corr(rot):  # the dim whose wavelength turns ``rot`` times over 4096 positions
        return d * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo, hi = math.floor(corr(32)), math.ceil(corr(1))
    assert (lo, hi) == (10, 23)
    want = []
    for i in range(d // 2):
        extra = base ** (-2 * i / d)
        ramp = min(max((i - lo) / (hi - lo), 0.0), 1.0)
        want.append(extra / 40 * ramp + extra * (1 - ramp))
    got = yarn_inv_freq(d, base, ROPE)
    torch.testing.assert_close(got.double(), torch.tensor(want, dtype=torch.float64),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(ref.inv_freq(dict(TINY, qk_rope_head_dim=64)), got, rtol=0, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    cfg = DeepseekV2Config()
    assert rope_mscale(ROPE) == 1.0
    assert softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert ref.attn_scale(dict(TINY, qk_nope_head_dim=128, qk_rope_head_dim=64)) == (
        pytest.approx(softmax_scale(cfg), rel=1e-12))


def test_rope_published_layout():
    """modeling_deepseek.py's ``apply_rotary_pos_emb``: view (d/2, 2),
    transpose, reshape, then ``x * cos + rotate_half(x) * sin``."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 5, 8, generator=g)
    cos, sin = torch.randn(5, 8, generator=g), torch.randn(5, 8, generator=g)
    b, h, s, d = x.shape
    y = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    rot = torch.cat((-y[..., d // 2:], y[..., :d // 2]), dim=-1)
    want = y * cos + rot * sin
    assert torch.equal(apply_rope(x, cos, sin), want)
    assert torch.equal(ref.rope(x, cos, sin), want)


def test_expert_share_sums_to_the_whole_layer():
    """Eight cards of two experts each: their partial outputs, the shared
    experts counted once, add up to the uncut layer's."""
    cfg = DeepseekV2Config(**TINY)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 7, TINY["hidden_size"], generator=g)
    whole = MoE(cfg, 0, 16, counters="moe.whole")
    for p in whole.parameters():
        p.data = torch.randn(p.shape, generator=g) / p.shape[-2] ** 0.5
    total, shared = 0, whole.shared(x)
    for card in range(8):
        part = MoE(cfg, 2 * card, 2, counters="moe.part")
        part.shared.load_state_dict(whole.shared.state_dict())
        part.router.data = whole.router.data
        for name in ("w_gate", "w_up", "w_down"):
            setattr(part.experts, name, torch.nn.Parameter(
                getattr(whole.experts, name).data[2 * card:2 * card + 2]))
        with torch.no_grad():
            total = total + part(x) - shared
    w = {f"mlp.{n}": t.detach() for n, t in whole.named_parameters()}
    uncut = ref.moe(w, "mlp.", x, TINY, 0, 16, "f32")
    torch.testing.assert_close(total + shared, uncut, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(whole(x).detach(), uncut, rtol=1e-5, atol=1e-5)


def test_kd_step_equals_reference():
    """One 4-bit KD step through ``make_train_step`` + ``lm_task`` (the
    router full precision) against ``reference.deepseek_v2.follow``: the
    loss, every parameter's gradient as Adam took it, and the change."""
    no_tf32()
    student, teacher = _model(counters="moe.s"), _model(counters="moe.t")
    w_teacher = _weights(teacher)
    w_student = {n: t.clone() for n, t in w_teacher.items()}
    for n, p in student.named_parameters():
        p.data.copy_(w_student[n])
    lr, clip = 1e-3, 1.0
    tx = build_optimizer(TrainConfig(learning_rate=lr, clip_norm=clip))
    quant = QuantSpec(bits=4, bucket_size=256,
                      exclude_substrings=QuantSpec().exclude_substrings + ("router",))
    step = make_train_step(lm_task(student, teacher, device="cpu"), tx, quant=quant,
                           distill=DistillSpec(weight=1.0, temperature=1.0), device="cpu")
    state = create_train_state(dict(student.named_parameters()), tx, device="cpu")
    toks = _tokens(2, 2, 17)
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    state, metrics = step(state, batch, 0)
    cfg = dict(TINY, train={"learning_rate": lr, "clip_norm": clip, "distill_weight": 1.0,
                            "temperature": 1.0},
               quant={"bits": 4, "bucket_size": 256, "exclude": ["router"]})
    want = ref.follow(cfg, 4, 4, w_student, w_teacher, [batch])
    assert float(metrics["loss"]) == pytest.approx(want["loss"][0], rel=2e-5)
    assert float(metrics["loss"]) > 0
    got_grad = {n: float(torch.linalg.vector_norm(m) / 0.1)
                for n, m in state.opt_state.mu.items()}
    for n in want["grad"]:
        assert got_grad[n] == pytest.approx(want["grad"][n], rel=2e-5, abs=2e-6), n
        change = float(torch.linalg.vector_norm(state.params[n].detach() - w_student[n]))
        assert change == pytest.approx(want["change"][n], rel=1e-4, abs=1e-7), n


def test_path_on_the_cpu_is_correct_and_counts():
    """The benchmark cell's path at tiny widths: correct under its limits,
    the held pairs counted, none dropped, and the half-batch fault and the
    TF32 control read past the limits."""
    import json
    import time

    from portbench import harness
    from portbench.paths import train_kd_moe

    with open(harness.HERE / "configs" / "deepseek-v2-lite-ep8-4bit.json") as f:
        cfg = json.load(f)
    with open(harness.HERE / "traffic" / "lm-zipf-4x4096.json") as f:
        tr = json.load(f)
    cfg.update({k: v for k, v in TINY.items() if k not in ("n_routed_experts", "rope_scaling")},
               router_experts=16, n_routed_experts=4, first_expert=4)
    tr.update(batch_size=2, bptt=16, windows=5, trace_units=2)
    with open(harness.HERE / "limits" / "dsv2lite-moe-kd-train.json") as f:
        limits = json.load(f)
    cell = harness.Cell(name="dsv2lite-moe-kd-train", config=cfg, traffic=tr, limits=limits,
                        chips=1, end_to_end=[], per_layer=[], peaks={})
    o = train_kd_moe.run(cell, 2 ** 33 + 7, 0.2, True, "cpu", time.perf_counter(),
                         control="tf32")
    assert harness.correct(o) and o.failed == 0 and o.attempted >= 2
    shapes = o.record["unit_shapes"]
    assert len(shapes) == 2 and all(s["held_pairs"] > 0 and s["held_pairs_teacher"] > 0
                                    for s in shapes)
    assert "dropped 0" in o.notes["pairs"]
    assert any(o.notes[f"half.{k}"] > limits[k] for k in limits)
    assert any(o.notes[f"tf32.{k}"] > limits[k] for k in limits)


# ------------------------------------------------------- the grouped matmul


def _per_expert(x, rows, w, offsets, p):
    out = torch.zeros(p, w.shape[2], dtype=x.dtype)
    b = offsets.tolist()
    for g in range(w.shape[0]):
        for r in range(b[g], b[g + 1]):
            out[r] = (x[rows[r]] if rows is not None else x[r]) @ w[g]
    return out


CASES = {
    "uneven": [3, 0, 5, 1],
    "empty": [0, 0, 0, 0],
    "one_group_all": [0, 9, 0, 0],
    "with_discard": [2, 2, 0, 3],
}


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_grouped_matmul_cpu_and_autograd(case, gather):
    g = torch.Generator().manual_seed(7)
    sizes = CASES[case]
    held = sum(sizes)
    p = held + (4 if case == "with_discard" else 0)  # discard rows after the held groups
    offsets = torch.tensor([0] + list(torch.tensor(sizes).cumsum(0)), dtype=torch.int64)
    w = torch.randn(4, 6, 5, generator=g, requires_grad=True)
    if gather:
        x = torch.randn(5, 6, generator=g, requires_grad=True)
        rows = torch.randint(0, 5, (p,), generator=g)
    else:
        x = torch.randn(p, 6, generator=g, requires_grad=True)
        rows = None
    before = dict(launch_counts())
    covered = torch.zeros(4, dtype=torch.int64)
    y = grouped_matmul(x, rows, w, offsets, covered)
    assert launch_counts() == before  # the CPU path launches nothing
    assert covered.tolist() == sizes
    assert y.shape == (p, 5)
    assert torch.equal(y, _per_expert(x.detach(), rows, w.detach(), offsets, p))
    assert not y[held:].any()  # the discard group is 0
    dy = torch.randn(p, 5, generator=g)
    (y * dy).sum().backward()
    x2, w2 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    # (+ 0 · the inputs: with no rows at all the loop reaches neither)
    ((_per_expert(x2, rows, w2, offsets, p) * dy).sum() + 0 * (x2.sum() + w2.sum())).backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-5, atol=1e-5)
    if sizes[1] == 0:
        assert not w.grad[1].any()  # an empty expert gets no gradient


def test_grouped_matmul_rejects():
    w = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="offsets"):
        grouped_matmul(torch.zeros(5, 3), None, w, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="expected"):
        grouped_matmul(torch.zeros(5, 4), None, w, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="rows"):
        grouped_matmul(torch.zeros(5, 3), torch.zeros(5), w, torch.zeros(3, dtype=torch.int64))


# --------------------------------------------------------- device counters


def test_device_counters_accumulate_and_reset():
    reset_device_counts()
    device_count("test.pairs", torch.tensor([1, 2, 3]))
    device_count("test.pairs", torch.tensor([1, 0, 1]))
    device_count("test.total", torch.tensor(4))
    got = device_counts()
    assert got["test.pairs"] == [2, 2, 4] and got["test.total"] == 4
    reset_device_counts()
    assert device_counts()["test.pairs"] == [0, 0, 0]
    device_count("test.total", torch.tensor(1))
    assert device_counts()["test.total"] == 1
    with pytest.raises(ValueError, match="test.total"):
        device_count("test.total", torch.tensor([1, 2]))


def test_moe_counts_its_pairs():
    m = _model(counters="moe.counted")
    reset_device_counts()
    toks = _tokens(3)
    m(toks)
    m(toks)
    got = device_counts()
    assert got["moe.counted.dropped"] == 0
    assert len(got["moe.counted.held_pairs"]) == 4
    # every pair routed to a held expert is counted, from the router's own choice
    want = 0
    x = m.embed.embedding[toks]
    cos, sin = m.rope(toks.shape[1])
    with torch.no_grad():
        for layer in m.layers:
            if isinstance(layer.mlp, MoE):
                _, idx = layer.mlp.route(layer.mlp_norm(x + layer.attn(layer.attn_norm(x), cos,
                                                                        sin)).reshape(-1, 64))
                want += int(((idx >= 4) & (idx < 8)).sum())
            x = layer(x, cos, sin)
    assert sum(got["moe.counted.held_pairs"]) == 2 * want


def test_moe_counts_a_drop(monkeypatch):
    """``dropped`` reads what the grouped kernel covers: a kernel whose row
    tiles miss the last row of every group shows drops."""
    from quantized_distillation_tpu_torch.models import deepseek_v2

    real = deepseek_v2.grouped_matmul

    def missing_a_row(x, rows, w, offsets, covered=None):
        if covered is not None:
            covered += (offsets[1:] - offsets[:-1] - 1).clamp(min=0)
        return real(x, rows, w, offsets)

    monkeypatch.setattr(deepseek_v2, "grouped_matmul", missing_a_row)
    m = _model(counters="moe.lossy")
    reset_device_counts()
    m(_tokens(5))
    got = device_counts()
    assert got["moe.lossy.dropped"] > 0


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    no_tf32()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [[1536, 0, 3001, 17, 1, 900, 64, 2000],
                                   [0, 0, 0, 6000, 0, 0, 0, 0]], ids=["uneven", "one_group"])
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)])
def test_gpu_grouped_matmul_at_the_cell_widths(cuda, sizes, k, n):
    g = torch.Generator(device=cuda).manual_seed(11)
    held = sum(sizes)
    p = held + 777  # a discard group
    offsets = torch.tensor([0] + list(torch.tensor(sizes).cumsum(0)), dtype=torch.int64,
                           device=cuda)
    t = 3000
    x = torch.randn(t, k, generator=g, device=cuda, requires_grad=True)
    rows = torch.randint(0, t, (p,), generator=g, device=cuda)
    w = (torch.randn(8, k, n, generator=g, device=cuda) / k ** 0.5).requires_grad_()
    before = launch_counts()
    covered = torch.zeros(8, dtype=torch.int64, device=cuda)
    y = grouped_matmul(x, rows, w, offsets, covered)
    dy = torch.randn(p, n, generator=g, device=cuda)
    y.backward(dy)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["grouped_matmul"] - before["grouped_matmul"] == 2  # forward, data gradient
    assert after["grouped_matmul_wgrad"] - before["grouped_matmul_wgrad"] == 1
    xc, wc = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    want = torch.zeros(p, n, device=cuda)
    b = offsets.tolist()
    for e in range(8):
        if b[e + 1] > b[e]:
            want = want.index_copy(0, torch.arange(b[e], b[e + 1], device=cuda),
                                   xc[rows[b[e]:b[e + 1]]] @ wc[e])
    want.backward(dy)
    # f32 on both sides (TF32 off), each sum over up to 6,000 terms in another
    # order: a few ulps of the sum's scale (TF32 would part them by ~1e-3)
    for got, ref_ in ((y, want), (x.grad, xc.grad), (w.grad, wc.grad)):
        scale = float(ref_.detach().abs().max())
        torch.testing.assert_close(got, ref_, rtol=1e-5, atol=2e-5 * scale)
    assert not y[held:].any()
    assert covered.tolist() == sizes


@pytest.mark.gpu
def test_gpu_captured_moe_counts_on_each_replay(cuda):
    """An MoE layer captured in a CUDA graph: the device counters move on
    every replay, and the replay's output equals an eager call's."""
    from quantized_distillation_tpu_torch.utils.graphs import CapturedStep

    cfg = DeepseekV2Config(**dict(TINY, hidden_size=256, moe_intermediate_size=128))
    moe = MoE(cfg, 4, 4, counters="moe.graph").to(cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    for p in moe.parameters():
        p.data = torch.randn(p.shape, generator=g, device=cuda) / p.shape[-2] ** 0.5
    x = torch.randn(64, 256, generator=g, device=cuda)
    out = torch.zeros(64, 256, device=cuda)

    def body():
        with torch.no_grad():
            out.copy_(moe(x))

    reset_device_counts()
    graph = CapturedStep(body, counted_warmup=True)  # the warm-up counts once
    one = device_counts()
    assert one["moe.graph.dropped"] == 0 and sum(one["moe.graph.held_pairs"]) > 0
    graph.replay(3)
    four = device_counts()
    assert four["moe.graph.dropped"] == 0
    assert four["moe.graph.held_pairs"] == [4 * c for c in one["moe.graph.held_pairs"]]
    with torch.no_grad():
        torch.testing.assert_close(out, moe(x), rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_gpu_model_step_in_one_graph(cuda):
    """A tiny DeepSeek-V2 KD step on the card, captured once and replayed on
    new batches: each step's loss and gradient norm equal the eager
    step's. The learning rate is 0, so both sides run every step from the
    same weights (a nonzero one would let the index_add's atomic order
    carry a weight across a 4-bit level on one side only)."""
    cfg = dict(TINY, hidden_size=128)
    student = make_deepseek_v2(cfg, n_held=4, first_expert=4, counters="moe.gs", device=cuda)
    teacher = make_deepseek_v2(cfg, n_held=4, first_expert=4, counters="moe.gt", device=cuda,
                               seed=1)
    tx = build_optimizer(TrainConfig(learning_rate=0.0, clip_norm=1.0))
    quant = QuantSpec(bits=4, exclude_substrings=QuantSpec().exclude_substrings + ("router",))
    kw = dict(quant=quant, distill=DistillSpec(weight=1.0, temperature=1.0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    batches = []
    for _ in range(3):
        toks = torch.randint(0, 97, (2, 65), generator=g, device=cuda)
        batches.append({"input": toks[:, :-1], "target": toks[:, 1:]})
    got = {}
    for eager in (False, True):
        step = make_train_step(lm_task(student, teacher, device=cuda), tx, _eager=eager, **kw)
        state = create_train_state(dict(student.named_parameters()), tx, device=cuda)
        got[eager] = []
        for b in batches:
            state, metrics = step(state, copy.copy(b), 0)
            got[eager] += [float(metrics["loss"]), float(metrics["grad_norm"])]
        assert eager or step.captures == 1
    assert len(set(got[True])) == 6  # three batches, three losses
    assert got[False] == pytest.approx(got[True], rel=1e-5)
