"""Data-parallel training of the port (``make_train_step(mesh=,
grad_reduce_dtype=)``) over 4 gloo ranks (``parallel.launch.run_ranks``, one
spawn), against the port's one-process step and the JAX package's
reduced-precision step on its CPU mesh.

- f32 reduce (``grad_reduce_dtype=None``) on a (4, 1) mesh equals the
  one-process step on the whole batch: loss rtol 1e-5, parameters after one
  SGD step rtol 1e-5, atol 1e-6; the targets' masks differ row to row, so
  the shards' token weights differ;
- ``preferred_grad_reduce_dtype("cpu")`` (f16, as the JAX package's CPU
  backend) matches JAX's ``make_train_step(mesh=make_mesh(4, 1),
  grad_reduce_dtype=preferred_grad_reduce_dtype())`` on the same seq2seq
  batch within ``tests/test_trainer.py``'s tolerance (loss rtol 1e-5;
  parameters rtol 0.05, atol 1e-4), and every rank holds the same
  parameters;
- the recorded data-axis bytes with the 2-byte reduce are below 0.65 x the
  f32 step's;
- ten reduced-precision Adam steps lower the loss;
- a vision step (a CNN with BatchNorm) averages the shards' running
  statistics and gradients (each shard normalized by its own batch
  statistics, as JAX's reduced-precision path does);
- an LM step (``lm_task(thread_carry=True)``) keeps each rank's carry: the
  one its own rows give.

JAX is imported only inside the JAX-side fixture: the spawned ranks import
this module again.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.convert import params_from_numpy
from quantized_distillation_tpu_torch.models import (
    CNNSpec,
    ConvForwardNet,
    Seq2Seq,
    Seq2SeqConfig,
    make_lm,
)
from quantized_distillation_tpu_torch.parallel import DATA_AXIS, make_mesh, place_batch
from quantized_distillation_tpu_torch.parallel.comm import collective_budget
from quantized_distillation_tpu_torch.parallel.launch import run_ranks
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    lm_initial_carry,
    lm_task,
    make_train_step,
    nmt_task,
    preferred_grad_reduce_dtype,
    vision_task,
)
from quantized_distillation_tpu_torch.train.optim import apply_updates
from quantized_distillation_tpu_torch.train.trainer import as_batch, loss_and_grads

torch.set_num_threads(2)

D = 4  # data-parallel ranks
QUANT = QuantSpec(bits=4)
SGD = TrainConfig(learning_rate=1e-2, optimizer="sgd")
ADAM = TrainConfig(learning_rate=5e-3, clip_norm=5.0)
CNN = dict(conv=((8, True), (8, False)), fc=(16,), num_classes=10, dropout=0.0)
LM = dict(embed_dim=8, hidden=12, num_layers=1, dropout=0.0)
LM_V, LM_T = 20, 5


def _student(payload):
    return Seq2Seq(Seq2SeqConfig(**payload["cfg"]), device="cpu").load_params(
        params_from_numpy(payload["params"]))


def _params(state):
    return {n: t.detach().numpy().copy() for n, t in state.params.items()}


def _nmt_step(payload, mesh=None, grad_reduce_dtype=None, cfg=SGD, steps=1):
    """``steps`` steps of a seq2seq student on this rank's rows (the whole
    batch without a mesh) → (losses, params, data-axis wire bytes)."""
    student = _student(payload)
    task = nmt_task(student, device="cpu")
    tx = build_optimizer(cfg)
    state = create_train_state(dict(student.named_parameters()), tx, quant=QUANT, device="cpu")
    step = make_train_step(task, tx, quant=QUANT, mesh=mesh, grad_reduce_dtype=grad_reduce_dtype,
                           device="cpu")
    batch = payload["batch"] if mesh is None else place_batch(payload["batch"], mesh,
                                                              device="cpu")
    losses = []
    with collective_budget(mesh) as budget:
        for _ in range(steps):
            state, metrics = step(state, batch, 0)
            losses.append(float(metrics["loss"]))
    return losses, _params(state), budget.bytes_by_axis().get(DATA_AXIS, 0)


def _vision(seed=0):
    return ConvForwardNet(CNNSpec(**CNN), image_size=8, device="cpu", seed=seed)


def _vision_step(payload, mesh):
    model = _vision()
    task = vision_task(model, device="cpu")
    tx = build_optimizer(SGD)
    state = create_train_state(dict(model.named_parameters()), tx, quant=QUANT,
                               batch_stats=dict(model.named_buffers()), device="cpu")
    step = make_train_step(task, tx, quant=QUANT, mesh=mesh, device="cpu")
    state, metrics = step(state, place_batch(payload["images"], mesh, device="cpu"), 0)
    return {"loss": float(metrics["loss"]), "params": _params(state),
            "stats": {n: t.numpy().copy() for n, t in state.batch_stats.items()}}


def _lm_step(payload, mesh):
    model = make_lm("student_small", LM_V, device="cpu", seed=0, **LM)
    task = lm_task(model, thread_carry=True, device="cpu")
    tx = build_optimizer(SGD)
    state = create_train_state(dict(model.named_parameters()), tx, quant=QUANT,
                               carry=lm_initial_carry(model, payload["lm"]["input"].shape[0] // D),
                               device="cpu")
    step = make_train_step(task, tx, quant=QUANT, mesh=mesh, device="cpu")
    state, metrics = step(state, place_batch(payload["lm"], mesh, device="cpu"), 0)
    carry = [(c.numpy(), h.numpy()) for c, h in state.carry["student"]]
    return {"loss": float(metrics["loss"]), "params": _params(state), "carry": carry}


def _rank(rank, world, payload):
    mesh = make_mesh(D, 1)
    f32 = _nmt_step(payload, mesh)
    f16 = _nmt_step(payload, mesh, preferred_grad_reduce_dtype("cpu"))
    ten, _, _ = _nmt_step(payload, mesh, preferred_grad_reduce_dtype("cpu"), cfg=ADAM, steps=10)
    return {"f32": f32, "f16": f16, "ten": ten, "vision": _vision_step(payload, mesh),
            "lm": _lm_step(payload, mesh)}


@pytest.fixture(scope="module")
def jx():
    """tests/test_trainer.py's seq2seq setup (dropout 0, batch of 8), with
    target masks that differ row to row, and JAX's reduced-precision step on
    4 CPU devices."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.config import TrainConfig as JTrainConfig
    from quantized_distillation_tpu.models import make_seq2seq
    from quantized_distillation_tpu.parallel import make_mesh as jmake_mesh
    from quantized_distillation_tpu.parallel import place_batch as jplace_batch
    from quantized_distillation_tpu.train import (
        build_optimizer as jbuild,
        create_train_state as jstate,
        make_train_step as jstep,
        nmt_task as jnmt,
        preferred_grad_reduce_dtype as jpreferred,
    )

    student = make_seq2seq("student_small", 30, 40, dropout=0.0)
    rng = np.random.default_rng(3)
    mask = (np.arange(5)[None, :] < rng.integers(2, 6, (8, 1))).astype(np.float32)
    batch = {
        "src": rng.integers(3, 30, (8, 6)).astype(np.int32),
        "src_len": np.full((8,), 6, np.int32),
        "tgt_in": rng.integers(3, 40, (8, 5)).astype(np.int32),
        "tgt_out": rng.integers(3, 40, (8, 5)).astype(np.int32),
        "tgt_mask": mask,
    }
    sv = jax.jit(student.init)(jax.random.PRNGKey(1), batch["src"], batch["src_len"],
                               batch["tgt_in"])
    mesh = jmake_mesh(D, 1, devices=jax.devices()[:D])
    tx = jbuild(JTrainConfig(learning_rate=1e-2, optimizer="sgd"))
    state = jstate(sv["params"], tx, quant=JQuant(bits=4))
    step = jstep(jnmt(student), tx, quant=JQuant(bits=4), donate=False, mesh=mesh,
                 grad_reduce_dtype=jpreferred())
    state, metrics = step(state, jplace_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                              mesh), jax.random.PRNGKey(0))
    img = np.random.default_rng(5)
    lm_rng = np.random.default_rng(6)
    payload = {
        "params": jax.tree.map(np.asarray, sv["params"]),
        "cfg": dataclasses.asdict(student.cfg),
        "batch": batch,
        "images": {"image": img.standard_normal((8, 8, 8, 3)).astype(np.float32),
                   "label": img.integers(0, 10, (8,)).astype(np.int32)},
        "lm": {"input": lm_rng.integers(0, LM_V, (8, LM_T)).astype(np.int32),
               "target": lm_rng.integers(0, LM_V, (8, LM_T)).astype(np.int32)},
    }
    flat = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(jax.tree.map(np.asarray, state.params))
    assert jpreferred() == jnp.float16  # the JAX package's CPU choice
    return {"payload": payload, "loss": float(metrics["loss"]), "params": flat}


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    return run_ranks(_rank, D, args=(jx["payload"],), timeout=120, join_timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("dp")))


def _assert_params(got, want, rtol, atol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


def test_f32_reduce_equals_the_one_process_step(jx, ranks):
    (loss,), params, _ = _nmt_step(jx["payload"])
    for out in ranks:
        (dp_loss,), dp_params, _ = out["f32"]
        np.testing.assert_allclose(dp_loss, loss, rtol=1e-5)
        _assert_params(dp_params, params, rtol=1e-5, atol=1e-6)


def test_reduced_precision_step_matches_jax(jx, ranks):
    from quantized_distillation_tpu_torch.convert import flax_paths

    assert preferred_grad_reduce_dtype("cpu") == torch.float16
    assert preferred_grad_reduce_dtype("cuda") == torch.bfloat16
    for out in ranks:
        (loss,), params, _ = out["f16"]
        np.testing.assert_allclose(loss, jx["loss"], rtol=1e-5)
        for name, value in params.items():
            # a fused gate tensor holds its four flax leaves side by side
            want = np.concatenate([jx["params"][p] for p in flax_paths(name)], axis=-1)
            np.testing.assert_allclose(value, want, rtol=0.05, atol=1e-4, err_msg=name)
        _assert_params(params, ranks[0]["f16"][1], rtol=0, atol=0)  # every rank the same


def test_two_byte_reduce_halves_the_data_axis_bytes(ranks):
    for out in ranks:
        b_full, b_half = out["f32"][2], out["f16"][2]
        assert b_full > 0 and b_half > 0
        assert b_half < 0.65 * b_full, (b_half, b_full)


def test_reduced_precision_steps_lower_the_loss(ranks):
    for out in ranks:
        losses = out["ten"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]


def _shards(batch):
    n = next(iter(batch.values())).shape[0] // D
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(D)]


def test_vision_step_averages_statistics_and_gradients(jx, ranks):
    payload = jx["payload"]
    model = _vision()
    task = vision_task(model, device="cpu")
    params = {n: p.requires_grad_() for n, p in model.named_parameters()}
    stats = dict(model.named_buffers())
    losses, grads, new_stats = [], [], []
    for shard in _shards(payload["images"]):
        loss, _, g, updates = loss_and_grads(task, params, as_batch(shard, torch.device("cpu")),
                                             quant=QUANT, batch_stats=stats)
        losses.append(float(loss))
        grads.append(g)
        new_stats.append(updates["batch_stats"])
    mean = {n: sum(g[n] for g in grads) / D for n in grads[0]}
    tx = build_optimizer(SGD)
    upd, _ = tx.update(mean, tx.init(params), params)
    with torch.no_grad():
        apply_updates(params, upd)
    for out in ranks:
        v = out["vision"]
        np.testing.assert_allclose(v["loss"], np.mean(losses), rtol=1e-5)
        for name in stats:
            want = torch.stack([s[name] for s in new_stats]).mean(0).numpy()
            np.testing.assert_allclose(v["stats"][name], want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        _assert_params(v["params"], {n: t.detach().numpy() for n, t in params.items()},
                       rtol=1e-5, atol=1e-6)
    # the statistics moved, and differently on each shard
    assert not np.allclose(new_stats[0]["BatchNorm_0.running_mean"].numpy(),
                           new_stats[1]["BatchNorm_0.running_mean"].numpy())


def test_lm_step_keeps_each_ranks_carry(jx, ranks):
    payload = jx["payload"]
    model = make_lm("student_small", LM_V, device="cpu", seed=0, **LM)
    task = lm_task(model, thread_carry=True, device="cpu")
    params = {n: p.requires_grad_() for n, p in model.named_parameters()}
    for rank, (out, shard) in enumerate(zip(ranks, _shards(payload["lm"]))):
        batch = as_batch(shard, torch.device("cpu"))
        batch["carry"] = lm_initial_carry(model, shard["input"].shape[0])
        _, _, _, updates = loss_and_grads(task, params, batch, quant=QUANT)
        want = updates["carry"]["student"]
        for (c, h), (wc, wh) in zip(out["lm"]["carry"], want, strict=True):
            np.testing.assert_allclose(c, wc.detach().numpy(), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(h, wh.detach().numpy(), rtol=1e-5, atol=1e-6)
    # the carries are the ranks' own: they differ
    assert not np.allclose(ranks[0]["lm"]["carry"][0][1], ranks[1]["lm"]["carry"][0][1])
    assert len({out["lm"]["loss"] for out in ranks}) == 1


def test_grad_reduce_dtype_without_a_mesh_raises():
    student = _student_small()
    task = nmt_task(student, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        make_train_step(task, build_optimizer(SGD), grad_reduce_dtype=torch.bfloat16,
                        device="cpu")


def _student_small():
    from quantized_distillation_tpu_torch.models import make_seq2seq

    return make_seq2seq("student_small", 10, 10, hidden=8, embed_dim=4, device="cpu")
