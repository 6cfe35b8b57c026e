"""Tensor-parallel training of the port (``make_train_step(mesh=,
param_specs=)`` on ``place_params_seq2seq`` / ``place_params_lm`` shards)
over gloo ranks (``parallel.launch.run_ranks``: one spawn of 2 ranks for
mesh (1, 2), one of 4 for (2, 2) and (1, 4), one of 8 for (4, 2)).

Against the port's own one-process step on the same weights and batch, for
the seq2seq ``student_small`` at narrow widths (2 layers; dropout 0 and
0.3; a bidirectional encoder with dot attention; a KD teacher at
temperature 2) and the LM (untied with a KD teacher,
and tied with a threaded carry and dropout 0.2): each rank's local
gradients (reduced over ``data``) and SGD-updated shard equal the slices
of the one-process ones within rtol 1e-5, atol 1e-6; loss, metrics and
``grad_norm`` within rtol 1e-5. The one-process reference takes each
``data`` shard's rows with the dropout generator folded with that shard's
coordinate and weights the shards by their tokens, which with one shard is
the one-process step itself. The source vocab (30) does not split 4 ways,
so at ``model`` = 4 the source embedding stays whole on every rank. One
fake-quant call a step per rank, over the whole tree's buckets, its values
bit-identical to the one-process step's slices.

Against the JAX package: its ``make_train_step`` on ``place_params_lm`` /
``place_params_seq2seq`` params at ``make_mesh(model=2)`` (8 CPU devices,
the ``tests/test_lm_sharded.py`` shapes, and a seq2seq of the same size
with a teacher), against the port at (4, 2), with
``tests/test_torch_train.py``'s tolerances: loss and metrics rtol 1e-5,
gradients within 1e-4 of each leaf's largest |g|, SGD-updated parameters
rtol 1e-5, atol 1e-7, each against the JAX ``addressable_shards`` of its
mesh position. The port's step averages its metrics over ``data`` (as its
data-parallel step does, and JAX's reduced-precision path), so its
``nll_sum`` and ``n_tokens`` are the shards' mean: 4 of them are the JAX
step's global sums.

Differentiable quantization too: the seq2seq student in mode ``joint``
(2-bit codebooks from the whole leaves' quantiles) and the LM in mode
``codebooks`` (weights frozen), each codebook whole on every rank, held
the same way (the updated codebooks whole).

Also: the 2-byte gradient reduce on a (2, 2) mesh and each operator of
``parallel/tensor.py`` against its unsplit counterpart, forward and
backward. JAX is imported only inside the JAX-side fixture: the spawned
ranks import this module again.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.convert import flatten_tree, fuse_flax_leaves, params_from_numpy
from quantized_distillation_tpu_torch.models import (
    LMConfig,
    LSTMLanguageModel,
    Seq2Seq,
    Seq2SeqConfig,
    make_lm,
    make_seq2seq,
)
from quantized_distillation_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    ModelParallel,
    make_mesh,
    place_batch,
    place_params_seq2seq,
    placed_pspecs,
)
from quantized_distillation_tpu_torch.parallel import comm
from quantized_distillation_tpu_torch.parallel import tensor as tp
from quantized_distillation_tpu_torch.parallel.comm import collective_budget
from quantized_distillation_tpu_torch.parallel.launch import run_ranks
from quantized_distillation_tpu_torch.parallel.mesh import axis_index, axis_size
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    lm_task,
    make_train_step,
    nmt_task,
    preferred_grad_reduce_dtype,
)
from quantized_distillation_tpu_torch.train import quantize_tree as qt
from quantized_distillation_tpu_torch.train.optim import global_norm
from quantized_distillation_tpu_torch.train.trainer import (
    as_batch,
    loss_and_grads,
    reduce_over_data,
    step_generators,
    trainable,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")
QUANT = QuantSpec(bits=4)
SGD = TrainConfig(learning_rate=1e-2, optimizer="sgd", clip_norm=0.02)
RTOL, ATOL = 1e-5, 1e-6
SRC_V, TGT_V, LM_V = 30, 40, 24  # 30 rows do not split 4 ways: whole there
B, TS, TT = 8, 5, 4
CASES = {
    "s2s": dict(kind="s2s", dropout=0.0),
    "s2s_dropout": dict(kind="s2s", dropout=0.3),
    "s2s_bidirectional_dot": dict(kind="s2s", dropout=0.0, bidirectional=True, attn="dot"),
    "lm": dict(kind="lm", tie=False, dropout=0.0),
    "lm_tied_carry": dict(kind="lm", tie=True, dropout=0.2, carry=True),
    # differentiable quantization: learned codebooks, whole on every rank
    "s2s_joint": dict(kind="s2s", dropout=0.0, mode="joint", init="quantile"),
    "lm_codebooks": dict(kind="lm", tie=False, dropout=0.0, mode="codebooks", init="uniform"),
}
CODEBOOK = QuantSpec(bits=2, method="codebook")
SUM_METRICS = ("nll_sum", "n_tokens")
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)], 8: [(4, 2)]}
ALL_MESHES = [m for ms in MESHES.values() for m in ms]


def _setup(case):
    """(student, task, distill, batch, carry) of a case, seeded."""
    rng = np.random.default_rng(7)
    if case["kind"] == "s2s":
        student = make_seq2seq("student_small", SRC_V, TGT_V, hidden=16, embed_dim=8,
                               num_layers=2, dropout=case["dropout"], device="cpu", seed=1,
                               bidirectional=case.get("bidirectional", False),
                               attn_type=case.get("attn", "general"))
        teacher = make_seq2seq("student_small", SRC_V, TGT_V, hidden=12, embed_dim=8,
                               dropout=0.0, device="cpu", seed=2)
        mask = (np.arange(TT)[None, :] < rng.integers(2, TT + 1, (B, 1))).astype(np.float32)
        batch = {"src": rng.integers(3, SRC_V, (B, TS)), "src_len": rng.integers(2, TS + 1, (B,)),
                 "tgt_in": rng.integers(3, TGT_V, (B, TT)),
                 "tgt_out": rng.integers(3, TGT_V, (B, TT)), "tgt_mask": mask}
        return student, nmt_task(student, teacher, device="cpu"), DistillSpec(0.5, 2.0), batch, None
    student = make_lm("student_small", LM_V, embed_dim=8, hidden=8, num_layers=2,
                      dropout=case["dropout"], tie_embeddings=case["tie"], device="cpu", seed=1)
    batch = {"input": rng.integers(0, LM_V, (B, TS)), "target": rng.integers(0, LM_V, (B, TS))}
    if case.get("carry"):
        g = torch.Generator().manual_seed(3)
        carry = {"student": tuple((torch.randn(B, 8, generator=g), torch.randn(B, 8, generator=g))
                                  for _ in range(2)), "teacher": None}
        return student, lm_task(student, thread_carry=True, device="cpu"), None, batch, carry
    teacher = make_lm("student_small", LM_V, embed_dim=8, hidden=12, dropout=0.0, device="cpu",
                      seed=2)
    return student, lm_task(student, teacher, device="cpu"), DistillSpec(0.5, 1.0), batch, None


def _rows(tree, d, dp):
    """The ``d``-th of ``dp`` row blocks of every tensor of a tree."""
    if isinstance(tree, dict):
        return {k: _rows(v, d, dp) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_rows(v, d, dp) for v in tree)
    if tree is None:
        return None
    n = tree.shape[0] // dp
    return tree[d * n:(d + 1) * n]


def _np(tree):
    return {n: t.detach().numpy().copy() for n, t in tree.items()}


def _reference(name, dp):
    """The one-process step over ``dp`` data shards (see the module
    docstring): loss, metrics, grad norm, gradients, SGD-updated
    parameters, the new carry, whole."""
    case = CASES[name]
    student, task, distill, batch, carry = _setup(case)
    quant, mode = _quant_mode(case)
    params = {n: p.detach().clone().requires_grad_(mode != "codebooks")
              for n, p in student.named_parameters()}
    books = None
    if mode != "weights":
        books = {p: t.requires_grad_() for p, t in
                 qt.init_codebook_tree(params, quant, case["init"]).items()}
    wrt = trainable(params, books, mode)
    outs = []
    for d in range(dp):
        b = as_batch(_rows(batch, d, dp), CPU)
        if carry is not None:
            b["carry"] = _rows(carry, d, dp)
        q_gen, drop_gen = step_generators(CPU, 0, 0, d)
        outs.append(loss_and_grads(task, params, b, quant=quant, distill=distill,
                                   quant_generator=q_gen, dropout_generator=drop_gen,
                                   codebooks=books, mode=mode))
    tokens = torch.stack([o[1]["n_tokens"] for o in outs])
    w = tokens / tokens.sum()
    grads = {n: sum(wd * o[2][n] for wd, o in zip(w, outs)) for n in wrt}
    tx = build_optimizer(SGD)
    upd, _ = tx.update(grads, tx.init(wrt), wrt)
    new = {n: p.detach() + upd[n] for n, p in wrt.items()}
    metrics = {k: float(torch.stack([o[1][k] for o in outs]).mean()) for k in outs[0][1]}
    new_carry = None
    if carry is not None:
        new_carry = [tuple(torch.cat([o[3]["carry"]["student"][i][j].detach() for o in outs])
                           .numpy() for j in range(2)) for i in range(2)]
    return {"loss": float(sum(wd * o[0] for wd, o in zip(w, outs))), "metrics": metrics,
            "grad_norm": float(global_norm(grads)), "grads": _np(grads), "params": _np(new),
            "carry": new_carry}


def _quant_mode(case):
    return (CODEBOOK, case["mode"]) if "mode" in case else (QUANT, "weights")


def _count_fake_quant():
    """Wrap the fake-quant entry point of the tree transforms: → (calls,
    restore); each call records its bucket count."""
    calls, orig = [], qt.fake_quant_buckets

    def counted(buckets, *a, **k):
        calls.append(int(buckets.shape[0]))
        return orig(buckets, *a, **k)

    qt.fake_quant_buckets = counted
    return calls, lambda: setattr(qt, "fake_quant_buckets", orig)


def _tp_case(name, mesh, ref, grad_reduce_dtype=None):
    """This rank's run of a case: its reduced local gradients, one step
    (SGD-updated shard, metrics, fake-quant calls, collectives), its STE
    values; the reference's slices beside them."""
    case = CASES[name]
    student, task, distill, batch, carry = _setup(case)
    quant, mode = _quant_mode(case)
    whole = dict(student.named_parameters())
    specs = placed_pspecs(whole, mesh)
    mp = ModelParallel(mesh, specs)
    d, dp = axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)
    rows = place_batch(batch, mesh, device="cpu")
    local = place_params_seq2seq(whole, mesh, device="cpu")
    b = as_batch(rows, CPU)
    if carry is not None:
        b["carry"] = _rows(carry, d, dp)
    q_gen, drop_gen = step_generators(CPU, 0, 0, d)
    params = {n: t.clone().requires_grad_(mode != "codebooks") for n, t in local.items()}
    books = None
    if mode != "weights":
        books = {p: t.requires_grad_() for p, t in
                 qt.init_codebook_tree(params, quant, case["init"], mp).items()}
    loss, metrics, grads, _ = loss_and_grads(task, params, b, quant=quant, distill=distill,
                                             quant_generator=q_gen, dropout_generator=drop_gen,
                                             codebooks=books, mode=mode, model_parallel=mp)
    _, _, grads, _ = reduce_over_data(loss, metrics, grads, {}, mesh, torch.float32)
    # the fake-quant values of the shards against the one-process transform's slices
    if mode == "weights":
        q_local = qt.ste_quantize_tree_tp(local, quant, mp)
        q_whole = qt.ste_quantize_tree(whole, quant)
    else:
        q_local = qt.ste_codebook_tree_tp(local, books, quant, mp)
        q_whole = qt.ste_codebook_tree(whole, qt.init_codebook_tree(whole, quant, case["init"]),
                                       quant)
    q_exact = all(torch.equal(q_local[n], mp.local(n, q_whole[n])) for n in whole)

    tx = build_optimizer(SGD)
    state = create_train_state(local, tx, quant=quant, device="cpu", mode=mode,
                               codebook_init=case.get("init", "uniform"), mesh=mesh,
                               param_specs=specs,
                               carry=None if carry is None else _rows(carry, d, dp))
    step = make_train_step(task, tx, quant=quant, distill=distill, mode=mode, mesh=mesh,
                           param_specs=specs, grad_reduce_dtype=grad_reduce_dtype, device="cpu")
    calls, restore = _count_fake_quant()
    try:
        with collective_budget(mesh) as budget:
            state, m = step(state, rows, 0)
    finally:
        restore()
    kinds = {}
    for op in budget.ops:
        kinds[f"{op.kind}@{op.axis}"] = kinds.get(f"{op.kind}@{op.axis}", 0) + 1
    out = {
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "metrics": {k: float(v) for k, v in m.items() if k not in ("loss", "grad_norm")},
        "grads": _np(grads), "fake_quant_calls": calls,
        "params": _np(trainable(state.params, state.codebooks, mode)),
        "q_exact": q_exact, "kinds": kinds, "split": sorted(n for n in whole if mp.is_split(n)),
    }
    if ref is not None:
        out["ref_grads"] = {n: mp.local(n, torch.from_numpy(g)).numpy() for n, g in ref["grads"].items()}
        out["ref_params"] = {n: mp.local(n, torch.from_numpy(g)).numpy()
                             for n, g in ref["params"].items()}
    if carry is not None:
        out["carry"] = [tuple(t.numpy() for t in ch) for ch in state.carry["student"]]
    return out


# ------------------------------------------------------------ the operators

OPS = ("copy_to_model", "reduce_from_model", "gather_from_model", "gather_to_split",
       "split_to_model", "vocab_parallel_embedding", "vocab_parallel_logsumexp",
       "vocab_parallel_nll", "vocab_parallel_kd_kl")


def _op_inputs(m):
    g = torch.Generator().manual_seed(11)
    return {
        "x": torch.randn(3, 4 * m, generator=g),
        # the upstream gradient each rank sees (one per rank)
        "grads": [torch.randn(3, 4 * m, generator=g) for _ in range(m)],
        "table": torch.randn(6 * m, 5, generator=g),
        "ids": torch.randint(0, 6 * m, (3, 4), generator=g),
        "g_emb": torch.randn(3, 4, 5, generator=g),
        "logits": torch.randn(2, 3, 8 * m, generator=g),
        "labels": torch.randint(0, 8 * m, (2, 3), generator=g),
        "teacher": torch.randn(2, 3, 8 * m, generator=g),
    }


def _op_results(mesh):
    """Each operator's output and input gradient on this rank."""
    mp = ModelParallel(mesh, {})
    m, r = mp.size, mp.index
    inp = _op_inputs(m)
    res = {}

    def run(name, fn, x, g):
        x = x.clone().requires_grad_()
        y = fn(x)
        (gx,) = torch.autograd.grad(y, x, g)
        res[name] = (y.detach().numpy(), gx.numpy())

    x, gr = inp["x"], inp["grads"][r]
    xl = tp.local_columns(x, mp).contiguous()
    run("copy_to_model", lambda t: tp.copy_to_model(t, mp), x, gr)
    run("reduce_from_model", lambda t: tp.reduce_from_model(t, mp), x * (r + 1), gr)
    run("gather_from_model", lambda t: tp.gather_from_model(t, mp), xl, gr)
    run("gather_to_split", lambda t: tp.gather_to_split(t, mp), xl, gr)
    run("split_to_model", lambda t: tp.split_to_model(t, mp), x, tp.local_columns(gr, mp))
    tl = inp["table"][r * 6:(r + 1) * 6]
    run("vocab_parallel_embedding", lambda t: tp.vocab_parallel_embedding(t, inp["ids"], mp),
        tl, inp["g_emb"])
    ll = tp.local_columns(inp["logits"], mp).contiguous()
    ones = torch.ones(2, 3)
    run("vocab_parallel_logsumexp", lambda t: tp.vocab_parallel_logsumexp(t, mp), ll, ones)
    run("vocab_parallel_nll", lambda t: tp.vocab_parallel_nll(t, inp["labels"], mp), ll, ones)
    run("vocab_parallel_kd_kl", lambda t: tp.vocab_parallel_kd_kl(t, inp["teacher"], 2.0, mp),
        ll, ones)
    # the new collective helpers, and what each records
    with collective_budget(mesh) as budget:
        res["comm"] = {
            "all_gather_dim": comm.all_gather_dim(xl, mesh, MODEL_AXIS, -1).numpy(),
            "reduce_scatter": comm.reduce_scatter(x * (r + 1), mesh, MODEL_AXIS, -1).numpy(),
            "pmax": comm.pmax(x * (r + 1), mesh, MODEL_AXIS).numpy(),
        }
    res["comm_ops"] = [(op.kind, op.bytes, op.axis, op.group_size) for op in budget.ops]
    return res


def _op_expected(name, m, r):
    """The unsplit counterpart: (output, input gradient) on rank ``r``."""
    inp = _op_inputs(m)
    x, grads = inp["x"], inp["grads"]
    w = x.shape[-1] // m
    cols = slice(r * w, (r + 1) * w)
    if name == "copy_to_model":
        return x, sum(grads)
    if name == "reduce_from_model":
        return x * sum(range(1, m + 1)), grads[r]
    if name == "gather_from_model":
        return x, grads[r][:, cols]
    if name == "gather_to_split":
        return x, sum(grads)[:, cols]
    if name == "split_to_model":
        return x[:, cols], torch.cat([g[:, s * w:(s + 1) * w] for s, g in enumerate(grads)],
                                     dim=-1)
    if name == "vocab_parallel_embedding":
        t = inp["table"].clone().requires_grad_()
        y = t[inp["ids"]]
        (gt,) = torch.autograd.grad(y, t, inp["g_emb"])
        return y, gt[r * 6:(r + 1) * 6]
    logits = inp["logits"].clone().requires_grad_()
    v = logits.shape[-1] // m
    fn = {"vocab_parallel_logsumexp": lambda t: torch.logsumexp(t, dim=-1),
          "vocab_parallel_nll": lambda t: -torch.gather(torch.log_softmax(t, -1), -1,
                                                        inp["labels"][..., None])[..., 0],
          "vocab_parallel_kd_kl": lambda t: (torch.softmax(inp["teacher"] / 2, -1) * (
              torch.log_softmax(inp["teacher"] / 2, -1) - torch.log_softmax(t / 2, -1))).sum(-1)}
    y = fn[name](logits)
    (gl,) = torch.autograd.grad(y, logits, torch.ones_like(y))
    return y, gl[..., r * v:(r + 1) * v]


# ------------------------------------------------------------ the ranks


def _rank(rank, world, payload):
    out = {}
    for shape in MESHES[world]:
        mesh = make_mesh(*shape)
        res = {"cases": {name: _tp_case(name, mesh, payload["refs"][(name, shape[0])])
                         for name in CASES}}
        if shape[0] == 1:
            res["ops"] = _op_results(mesh)
        if shape == (2, 2):
            res["f16"] = _tp_case("s2s", mesh, None, preferred_grad_reduce_dtype("cpu"))
        out[shape] = res
    if world == 8:
        out["jax"] = {k: _jax_side(k, make_mesh(4, 2), payload["jax"][k]) for k in payload["jax"]}
    return out


def _port_model(kind, cfg, params):
    if kind == "lm":
        return LSTMLanguageModel(LMConfig(**cfg), device="cpu").load_params(params)
    return Seq2Seq(Seq2SeqConfig(**cfg), device="cpu").load_params(params_from_numpy(params))


def _port_named(model, tree):
    """A flax tree (numpy) keyed by the port model's parameter names."""
    return fuse_flax_leaves(flatten_tree(params_from_numpy(tree)),
                            [n for n, _ in model.named_parameters()])


def _jax_side(kind, mesh, spec):
    """The port at (4, 2) on the JAX test's weights and batch: reduced local
    gradients, the SGD-updated shard, loss and metrics; and the JAX
    gradients' slices for this rank."""
    model = _port_model(kind, spec["cfg"], spec["params"])
    if kind == "lm":
        task, distill = lm_task(model, device="cpu"), DistillSpec(weight=0.0)
    else:
        teacher = _port_model("s2s", spec["teacher_cfg"], spec["teacher_params"])
        task, distill = nmt_task(model, teacher, device="cpu"), DistillSpec()
    whole = dict(model.named_parameters())
    specs = placed_pspecs(whole, mesh)
    mp = ModelParallel(mesh, specs)
    local = place_params_seq2seq(whole, mesh, device="cpu")
    rows = place_batch(spec["batch"], mesh, device="cpu")
    params = {n: t.clone().requires_grad_() for n, t in local.items()}
    loss, metrics, grads, _ = loss_and_grads(task, params, as_batch(rows, CPU), quant=QUANT,
                                             distill=distill, model_parallel=mp)
    _, _, grads, _ = reduce_over_data(loss, metrics, grads, {}, mesh, torch.float32)
    tx = build_optimizer(spec["train_cfg"])
    state = create_train_state(local, tx, quant=QUANT, device="cpu")
    step = make_train_step(task, tx, quant=QUANT, distill=distill, mesh=mesh, param_specs=specs,
                           device="cpu")
    state, m = step(state, rows, 0)
    jgrads = _port_named(model, spec["grads"])
    return {"loss": float(m["loss"]), "metrics": {k: float(v) for k, v in m.items()},
            "grads": _np(grads), "params": _np(state.params),
            "jax_grads": {n: mp.local(n, g).numpy() for n, g in jgrads.items()}}


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def refs():
    return {(name, dp): _reference(name, dp) for name in CASES for dp in {m[0] for m in ALL_MESHES}}


@pytest.fixture(scope="module")
def ranks2(refs, tmp_path_factory):
    return run_ranks(_rank, 2, args=({"refs": refs},), timeout=120, join_timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("tp2")))


@pytest.fixture(scope="module")
def ranks4(refs, tmp_path_factory):
    return run_ranks(_rank, 4, args=({"refs": refs},), timeout=120, join_timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("tp4")))


def _jax_case(kind):
    """The JAX step on placed params at make_mesh(model=2): its loss,
    metrics, whole gradients (the jitted value_and_grad of the step's loss
    on the placed params and batch), and the updated params' shards at
    each mesh position."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import DistillSpec as JDistill
    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.config import TrainConfig as JTrainConfig
    from quantized_distillation_tpu.models import make_lm as jmake_lm
    from quantized_distillation_tpu.models import make_seq2seq as jmake_s2s
    from quantized_distillation_tpu.parallel import make_mesh as jmake_mesh
    from quantized_distillation_tpu.parallel import place_batch as jplace_batch
    from quantized_distillation_tpu.parallel import place_params_lm as jplace_lm
    from quantized_distillation_tpu.parallel import place_params_seq2seq as jplace_s2s
    from quantized_distillation_tpu.train import build_optimizer as jbuild
    from quantized_distillation_tpu.train import create_train_state as jstate
    from quantized_distillation_tpu.train import lm_task as jlm_task
    from quantized_distillation_tpu.train import make_train_step as jstep
    from quantized_distillation_tpu.train import nmt_task as jnmt_task
    from quantized_distillation_tpu.train import trainer as jtrainer

    mesh = jmake_mesh(model=2)
    vocab, hidden, b, t = 64, 32, 8, 6
    rng = np.random.default_rng(5)
    quant = JQuant(bits=4)
    spec = {"train_cfg": SGD}
    if kind == "lm":
        model = jmake_lm("student_small", vocab, hidden=hidden, embed_dim=hidden, dropout=0.0)
        batch = {"input": rng.integers(0, vocab, (b, t)).astype(np.int32),
                 "target": rng.integers(0, vocab, (b, t)).astype(np.int32)}
        v = model.init(jax.random.PRNGKey(0), jnp.asarray(batch["input"]))
        params = jplace_lm(v["params"], mesh)
        task, distill = jlm_task(model), JDistill(weight=0.0)
    else:
        model = jmake_s2s("student_small", vocab, vocab, hidden=hidden, embed_dim=32, dropout=0.0)
        teacher = jmake_s2s("student_small", vocab, vocab, hidden=2 * hidden, embed_dim=32,
                            dropout=0.0)
        mask = (np.arange(t)[None, :] < rng.integers(3, t + 1, (b, 1))).astype(np.float32)
        batch = {"src": rng.integers(3, vocab, (b, t)).astype(np.int32),
                 "src_len": rng.integers(2, t + 1, (b,)).astype(np.int32),
                 "tgt_in": rng.integers(3, vocab, (b, t)).astype(np.int32),
                 "tgt_out": rng.integers(3, vocab, (b, t)).astype(np.int32), "tgt_mask": mask}
        args = [jnp.asarray(batch[k]) for k in ("src", "src_len", "tgt_in")]
        v = model.init(jax.random.PRNGKey(0), *args)
        tv = teacher.init(jax.random.PRNGKey(1), *args)
        params = jplace_s2s(v["params"], mesh)
        task = jnmt_task(model, teacher, {"params": jplace_s2s(tv["params"], mesh)})
        distill = JDistill()
        spec["teacher_cfg"] = dataclasses.asdict(teacher.cfg)
        spec["teacher_params"] = jax.tree.map(np.asarray, tv["params"])
    jb = jplace_batch({k: jnp.asarray(x) for k, x in batch.items()}, mesh)

    def loss_fn(p):
        q = jtrainer.quantized_params(p, quant, None, None)
        logits, _ = task.student_forward({"params": q}, jb, True, {"dropout": jax.random.PRNGKey(0)})
        teacher_logits = task.teacher_forward(jb) if task.teacher_forward else None
        return task.loss_and_metrics(logits, teacher_logits, jb, distill)

    (_, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jbuild(JTrainConfig(learning_rate=SGD.learning_rate, optimizer="sgd",
                             clip_norm=SGD.clip_norm))
    state = jstate(params, tx, quant=quant)
    step = jstep(task, tx, quant=quant, distill=distill, donate=False)
    state, metrics = step(state, jb, jax.random.PRNGKey(0))
    devices = np.asarray(mesh.devices)
    pos = {devices[i, j].id: (i, j) for i in range(devices.shape[0]) for j in range(devices.shape[1])}
    shards = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        for s in leaf.addressable_shards:
            shards.setdefault(pos[s.device.id], {})[key] = np.asarray(s.data)
    spec.update(cfg=dataclasses.asdict(model.cfg), params=jax.tree.map(np.asarray, v["params"]),
                batch=batch, grads=jax.tree.map(np.asarray, grads))
    return spec, {"loss": float(metrics["loss"]),
                  "metrics": {k: float(x) for k, x in metrics.items()}, "shards": shards}


@pytest.fixture(scope="module")
def jx():
    cases = {k: _jax_case(k) for k in ("lm", "s2s")}
    return {"payload": {k: c[0] for k, c in cases.items()}, "out": {k: c[1] for k, c in cases.items()}}


@pytest.fixture(scope="module")
def ranks8(refs, jx, tmp_path_factory):
    return run_ranks(_rank, 8, args=({"refs": refs, "jax": jx["payload"]},), timeout=120,
                     join_timeout=300, store_dir=str(tmp_path_factory.mktemp("tp8")))


@pytest.fixture
def ranks(request):
    """The spawn holding a mesh's ranks."""
    return lambda shape: request.getfixturevalue(f"ranks{shape[0] * shape[1]}")


# ------------------------------------------------------------ tests


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol, err_msg=f"{what} {n}")


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", ALL_MESHES)
def test_local_gradients_are_slices_of_the_one_process_ones(ranks, refs, shape, name):
    for out in ranks(shape):
        case = out[shape]["cases"][name]
        _close(case["grads"], case["ref_grads"], what=f"{shape} {name} grad")


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", ALL_MESHES)
def test_tp_step_equals_the_one_process_step(ranks, refs, shape, name):
    ref = refs[(name, shape[0])]
    for r, out in enumerate(ranks(shape)):
        case = out[shape]["cases"][name]
        _close(case["params"], case["ref_params"], what=f"{shape} {name} param")
        np.testing.assert_allclose(case["loss"], ref["loss"], rtol=RTOL)
        np.testing.assert_allclose(case["grad_norm"], ref["grad_norm"], rtol=RTOL)
        assert case["grad_norm"] > SGD.clip_norm  # the clip ran on the sharded norm
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(case["metrics"][k], v, rtol=RTOL, err_msg=k)
            if CASES[name]["dropout"] == 0 and k in SUM_METRICS:
                # averaged over data: D of them are the one-process sums
                whole = refs[(name, 1)]["metrics"][k]
                np.testing.assert_allclose(case["metrics"][k] * shape[0], whole, rtol=RTOL)
        if ref["carry"] is not None:  # the rank's rows of the whole new carry
            d, dp = r // shape[1], shape[0]
            for (c, h), (wc, wh) in zip(case["carry"], ref["carry"], strict=True):
                np.testing.assert_allclose(c, _rows(wc, d, dp), rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(h, _rows(wh, d, dp), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", ALL_MESHES)
def test_one_fake_quant_call_a_step_over_the_whole_tree(ranks, shape):
    for name in CASES:
        if "mode" in CASES[name]:  # codebook training launches no kernel, as in one process
            for out in ranks(shape):
                case = out[shape]["cases"][name]
                assert case["fake_quant_calls"] == [] and case["q_exact"], name
            continue
        student = _setup(CASES[name])[0]
        whole = sum(-(-x.numel() // QUANT.bucket_size)
                    for p, x in qt.flax_leaves(dict(student.named_parameters()))
                    if qt.is_quantizable(p, x, QUANT))
        for out in ranks(shape):
            case = out[shape]["cases"][name]
            assert case["fake_quant_calls"] == [whole], (name, case["fake_quant_calls"])
            assert case["q_exact"], name  # bit-identical to the one-process values' slices


@pytest.mark.parametrize("shape", ALL_MESHES)
def test_the_split_and_its_collectives(ranks, shape):
    out = ranks(shape)[0][shape]["cases"]
    s2s = set(out["s2s"]["split"])
    assert {"generator_kernel", "tgt_embed", "decoder.cells.0.wh", "decoder.attn.linear_in",
            "encoder.cells.1.wi"} <= s2s
    assert ("encoder.embedding" in s2s) == (SRC_V % shape[1] == 0)  # the fallback
    assert "embed.embedding" in out["lm_tied_carry"]["split"]
    for name, case in out.items():
        kinds = case["kinds"]
        for k in ("all-gather@model", "reduce-scatter@model", "all-reduce@model",
                  "all-reduce@data"):
            assert kinds.get(k, 0) > 0 or (k.endswith("@data") and shape[0] == 1), (name, k)


def test_two_byte_gradient_reduce_on_a_2x2_mesh(ranks4, refs):
    ref = refs[("s2s", 2)]
    for out in ranks4:
        f16 = out[(2, 2)]["f16"]
        np.testing.assert_allclose(f16["loss"], ref["loss"], rtol=RTOL)
        full = out[(2, 2)]["cases"]["s2s"]
        _close(f16["params"], full["params"], rtol=0.05, atol=1e-4, what="f16")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_operator_against_its_unsplit_counterpart(ranks, shape, op):
    for r, out in enumerate(ranks(shape)):
        y, g = out[shape]["ops"][op]
        want_y, want_g = _op_expected(op, shape[1], r)
        np.testing.assert_allclose(y, want_y.detach().numpy(), rtol=1e-6, atol=1e-6, err_msg=op)
        np.testing.assert_allclose(g, want_g.detach().numpy(), rtol=1e-6, atol=1e-6, err_msg=op)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_collective_helpers_and_their_records(ranks, shape):
    m = shape[1]
    x = _op_inputs(m)["x"]
    w = x.shape[-1] // m
    for r, out in enumerate(ranks(shape)):
        got = out[shape]["ops"]["comm"]
        np.testing.assert_array_equal(got["all_gather_dim"], x.numpy())
        total = x * sum(range(1, m + 1))
        np.testing.assert_allclose(got["reduce_scatter"], total[:, r * w:(r + 1) * w].numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["pmax"], torch.maximum(x, x * m).numpy())
        # bytes of the result, as XLA's HLO sizes a collective; the axis and
        # its group size
        assert out[shape]["ops"]["comm_ops"] == [("all-gather", x.numel() * 4, "model", m),
                                          ("reduce-scatter", x.numel() * 4 // m, "model", m),
                                          ("all-reduce", x.numel() * 4, "model", m)]


@pytest.mark.parametrize("kind", ["lm", "s2s"])
def test_port_at_4x2_matches_the_jax_step_on_placed_params(ranks8, jx, kind):
    want = jx["out"][kind]
    names = None
    for r, out in enumerate(ranks8):
        got = out["jax"][kind]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k, v in want["metrics"].items():
            # the port averages the metrics over data (the DP step's rule):
            # the sums are the shards' mean, D of them the global sums
            d = 4 if k in SUM_METRICS else 1
            np.testing.assert_allclose(got["metrics"][k] * d, v, rtol=1e-5, err_msg=k)
        for n, g in got["jax_grads"].items():
            scale = max(float(np.abs(g).max()), 1e-30)
            assert np.abs(got["grads"][n] - g).max() <= 1e-4 * scale, (kind, n)
        shard = want["shards"][(r // 2, r % 2)]
        model_names = list(got["params"])
        named = fuse_flax_leaves({p: torch.tensor(x) for p, x in shard.items()}, model_names)
        for n in model_names:
            np.testing.assert_allclose(got["params"][n], named[n].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{kind} {n} rank {r}")
        names = names or model_names
    assert names
