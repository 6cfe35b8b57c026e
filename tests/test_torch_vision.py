"""The PyTorch port's vision families (CNN, WideResNet, ResNet) and
``vision_task`` against the JAX package's, on the same weights and inputs
(numpy, from seeds), at small widths.

Inputs are 8×8 and 9×9, so a stride-2 3×3 ``SAME`` conv pads (0, 1) in one
and (1, 1) in the other; every forward runs in eval and in train mode
(BatchNorm on the batch's statistics, running statistics updated).
Parameters and statistics are perturbed from their init, so no BatchNorm
is the identity and no ResNet block's last scale is 0.

Tolerances (f32 on the CPU, summation order differs between XLA and
PyTorch): logits and running statistics rtol = atol = 1e-5; fake-quant
levels exactly and values within 2e-6; losses and metrics rtol 1e-5;
gradients within 1e-4 of each leaf's largest |gradient|; SGD-updated
parameters, codebooks and statistics rtol 1e-5, atol 1e-6.

Tests marked ``gpu`` run a step on the card against the CPU; they skip
where PyTorch sees no card. JAX is imported inside the CPU tests'
fixtures, so ``pytest -m gpu`` runs without JAX.
"""

import math
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.convert import (
    batch_stats_from_numpy,
    batch_stats_to_numpy,
    flatten_tree,
    flax_leaves,
    params_to_numpy,
)
from quantized_distillation_tpu_torch.kernels import fake_quant_buckets
from quantized_distillation_tpu_torch.models import (
    CNNSpec,
    ConvForwardNet,
    ResNet,
    WideResNet,
    make_cnn,
    make_lm,
    make_resnet,
    make_wrn,
)
from quantized_distillation_tpu_torch.models._layers import conv_same, same_pads
from quantized_distillation_tpu_torch.ops import uniform
from quantized_distillation_tpu_torch.ops.bucketing import num_buckets
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    evaluate,
    make_eval_step,
    make_train_step,
    vision_task,
)
from quantized_distillation_tpu_torch.train import quantize_tree as qt
from quantized_distillation_tpu_torch.train.trainer import as_batch, loss_and_grads

torch.set_num_threads(2)

RTOL = ATOL = 1e-5  # logits and running statistics
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's largest |gradient|
VALUE_ATOL = 2e-6
W_RTOL, W_ATOL = 1e-5, 1e-6
CLASSES = 10
SGD = dict(learning_rate=0.5, clip_norm=0.05, optimizer="sgd")

# family → the keywords both packages build it from (the CNN: its CNNSpec)
FAMILIES = {
    "wrn": dict(depth=10, widen=1, num_classes=CLASSES),
    "resnet_small_stem": dict(stage_sizes=(1, 1), bottleneck=True, width_mult=0.25,
                              num_classes=CLASSES, small_inputs=True),
    "resnet_imagenet_stem": dict(stage_sizes=(1, 1), bottleneck=True, width_mult=0.25,
                                 num_classes=CLASSES),
    "resnet_basic": dict(stage_sizes=(1, 1), width_mult=0.25, num_classes=CLASSES,
                         small_inputs=True),
    "cnn": dict(conv=((16, True), (8, False), (24, True)), fc=(32,), num_classes=CLASSES,
                dropout=0.0),
}


def _images(seed, size, b=4):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((b, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, (b,)).astype(np.int32)}


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import DistillSpec as JDistill
    from quantized_distillation_tpu.config import QuantSpec as JQuant
    from quantized_distillation_tpu.config import TrainConfig as JTrainConfig
    from quantized_distillation_tpu.models import cnn, resnet, wide_resnet
    from quantized_distillation_tpu.train import loops, tasks, trainer
    from quantized_distillation_tpu.train import quantize_tree as jqt

    def make(family, **kw):
        kw = {**FAMILIES[family], **kw}
        if family == "wrn":
            return wide_resnet.WideResNet(**kw)
        if family == "cnn":
            return cnn.ConvForwardNet(cnn.CNNSpec(**kw))
        return resnet.ResNet(**kw)

    return types.SimpleNamespace(jax=jax, jnp=jnp, Quant=JQuant, Distill=JDistill,
                                 TrainConfig=JTrainConfig, make=make, trainer=trainer,
                                 tasks=tasks, loops=loops, qt=jqt)


def _port_model(family, size, device="cpu", seed=0):
    kw = FAMILIES[family]
    if family == "wrn":
        return WideResNet(device=device, seed=seed, **kw)
    if family == "cnn":
        return ConvForwardNet(CNNSpec(**kw), image_size=size, device=device, seed=seed)
    return ResNet(device=device, seed=seed, **kw)


def _variables(jx, jm, x, seed):
    """Variables of the flax module ``jm`` in the tree ``init`` gives (its
    shapes from ``jax.eval_shape``, which runs no initializer): kernels
    N(0, 1/fan_in), scales 1 + N(0, 0.1^2), biases and means N(0, 0.1^2),
    variances 1 + |N(0, 0.1^2)|, so no BatchNorm is the identity and no
    ResNet block's last scale is 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        z = rng.standard_normal(shape.shape)
        name = path[-1].key
        if name == "kernel":
            z = z / np.sqrt(np.prod(shape.shape[:-1]))
        elif name in ("scale", "var"):
            z = 1 + 0.1 * (np.abs(z) if name == "var" else z)
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    shapes = jx.jax.eval_shape(jm.init, jx.jax.random.PRNGKey(0), x)
    return jx.jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _twin(jx, family, size, seed=0):
    """(flax module, its variables, the port model holding the same)."""
    jm = jx.make(family)
    jv = _variables(jx, jm, jx.jnp.zeros((1, size, size, 3)), seed)
    port = _port_model(family, size)
    port.load_params(jv["params"]).load_batch_stats(jv["batch_stats"])
    return jm, jv, port


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _nchw(image):
    return torch.from_numpy(image).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("size,k,stride,pads", [
    (8, 3, 2, (0, 1)), (9, 3, 2, (1, 1)), (8, 3, 1, (1, 1)), (8, 1, 2, (0, 0)),
    (9, 1, 2, (0, 0)), (7, 7, 2, (3, 3)), (8, 7, 2, (2, 3)),
])
def test_same_padding_is_lax_rule(jx, size, k, stride, pads):
    assert same_pads(size, k, stride) == pads
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)  # HWIO
    want = jx.jax.lax.conv_general_dilated(
        jx.jnp.asarray(x), jx.jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv_same(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    _close(got.permute(0, 2, 3, 1), want)


# ---------------------------------------------------------------- forwards


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_eval_and_train_match_jax(jx, family, size):
    jm, jv, port = _twin(jx, family, size)
    img = _images(1, size)["image"]
    x = jx.jnp.asarray(img)
    apply = jx.jax.jit(jm.apply, static_argnames=("train", "mutable"))
    _close(port(_nchw(img)), apply(jv, x, train=False), "eval logits")
    want, upd = apply(jv, x, train=True, mutable=("batch_stats",))
    before = {n: t.clone() for n, t in port.named_buffers()}
    got, stats = port.forward_with(dict(port.named_parameters()), _nchw(img), train=True)
    _close(got.detach(), want, "train logits")
    want_stats = flatten_tree(jx.jax.tree.map(np.asarray, upd["batch_stats"]))
    got_stats = flatten_tree(batch_stats_to_numpy(stats))
    assert got_stats.keys() == want_stats.keys()
    for path, w in want_stats.items():
        _close(got_stats[path], w, path)
    # the module's own statistics are untouched; eval reads the ones handed in
    assert all(torch.equal(t, before[n]) for n, t in port.named_buffers())
    (evl, used) = port.forward_with({**dict(port.named_parameters()), **stats}, _nchw(img))
    _close(evl, apply({"params": jv["params"], "batch_stats": upd["batch_stats"]}, x),
           "eval on the new statistics")
    assert all(used[n] is stats[n] for n in stats)


def test_cnn_flattens_in_flax_order(jx):
    # a 2x2x24 last map: flattening NCHW would feed Dense_0's rows in another order
    jm, jv, port = _twin(jx, "cnn", 8)
    img = _images(2, 8)["image"]
    perm = dict(port.named_parameters())
    assert tuple(perm["Dense_0.kernel"].shape) == (2 * 2 * 24, 32)
    _close(port(_nchw(img)), jm.apply(jv, jx.jnp.asarray(img)))


def test_resnet_zero_init_and_presets():
    m = ResNet(stage_sizes=(1, 1), bottleneck=True, width_mult=0.25, device="cpu")
    zero = {n for n, p in m.named_parameters() if n.endswith("weight") and not p.any()}
    assert zero == {"BottleneckBlock_0.BatchNorm_2.weight", "BottleneckBlock_1.BatchNorm_2.weight"}
    r18 = make_resnet("resnet18_half", 1000, device="cpu", seed=3)
    assert [n for n in r18.blocks] == [f"ResNetBlock_{i}" for i in range(8)]
    assert torch.equal(r18.stem.kernel, make_resnet("resnet18_half", device="cpu",
                                                    seed=3).stem.kernel)


# ------------------------------------------------------------- conversion


@pytest.mark.parametrize("family", list(FAMILIES))
def test_round_trip_reproduces_the_flax_tree(jx, family):
    _, jv, port = _twin(jx, family, 8)
    for got, want in ((params_to_numpy(port), jv["params"]),
                      (batch_stats_to_numpy(port), jv["batch_stats"])):
        got, want = flatten_tree(got), flatten_tree(want)
        assert got.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=path)
    stats = batch_stats_from_numpy(jv["batch_stats"])
    assert stats.keys() == dict(port.named_buffers()).keys()


@pytest.mark.parametrize("name,make,buckets,leaves,params", [
    # the students of the full-width train paths: 4-bit, buckets of 256
    ("wrn_16_4", lambda: make_wrn("student_medium", 100, device="cpu"), 10814, 17, 2772020),
    ("lm_student_medium", lambda: make_lm("student_medium", 10000, device="cpu"),
     24096, 18, 6180624),
    ("cnn_student_small", lambda: make_cnn("student_small", device="cpu"), 463, 5, 118778),
    ("resnet18_half", lambda: make_resnet("resnet18_half", device="cpu"), 11915, 21, 3055880),
])
def test_quantizable_leaves_of_the_full_width_students(name, make, buckets, leaves, params):
    model = make()
    spec = QuantSpec(bits=4)
    q = [x for p, x in flax_leaves(dict(model.named_parameters())) if qt.is_quantizable(p, x, spec)]
    assert len(q) == leaves
    assert sum(num_buckets(x.numel(), 256) for x in q) == buckets
    assert sum(p.numel() for p in model.parameters()) == params


# ---------------------------------------------------------- quantize tree


def test_wrn_leaves_paths_and_sizes_match_jax(jx):
    _, jv, port = _twin(jx, "wrn", 8)
    jflat = jx.jax.tree_util.tree_flatten_with_path(jv["params"])[0]
    jpaths = [jx.qt.path_str(p) for p, _ in jflat]
    params = dict(port.named_parameters())
    assert [p for p, _ in flax_leaves(params)] == jpaths
    spec, jspec = QuantSpec(bits=4), jx.Quant(bits=4)
    want = {jx.qt.path_str(p) for p, leaf in jflat
            if jx.qt.is_quantizable(jx.qt.path_str(p), leaf, jspec)}
    assert {p for p, x in flax_leaves(params) if qt.is_quantizable(p, x, spec)} == want
    assert qt.param_sizes(params) == jx.qt.param_sizes(jv["params"])


@pytest.mark.parametrize("scaling", ["linear", "absmax"])
def test_wrn_tree_values_match_jax_per_leaf(jx, scaling):
    _, jv, port = _twin(jx, "wrn", 8)
    params = {n: p.detach().clone() for n, p in port.named_parameters()}
    spec, jspec = QuantSpec(bits=4, scaling=scaling), jx.Quant(bits=4, scaling=scaling)
    jtree = jx.jax.tree.map(jx.jnp.asarray, jv["params"])
    jhard = flatten_tree(jx.jax.tree.map(np.asarray, jx.qt.quantize_tree_hard(jtree, jspec)))
    jpallas = jx.qt._fused_fake_quant_values(jtree, jspec, None, force=True)
    n0 = fake_quant_buckets.launches
    ste = flatten_tree(params_to_numpy(qt.ste_quantize_tree(params, spec)))
    hard = flatten_tree(params_to_numpy(qt.quantize_tree_hard(params, spec)))
    assert fake_quant_buckets.launches == n0  # CPU tensors run the plain version
    orig = flatten_tree(params_to_numpy(params))
    assert sum(p.endswith("Conv_0/kernel") for p in jpallas) == 3
    for path, want in jhard.items():
        if path not in jpallas:  # biases, BatchNorm scales: untouched
            np.testing.assert_array_equal(ste[path], orig[path])
            np.testing.assert_array_equal(hard[path], orig[path])
            continue
        for got in (ste[path], hard[path]):
            for ref in (want, np.asarray(jpallas[path])):
                np.testing.assert_allclose(got, ref, rtol=0, atol=VALUE_ATOL, err_msg=path)
                assert torch.equal(_levels(got, scaling), _levels(ref, scaling)), path


def _levels(x, scaling):
    return uniform.quantize(torch.from_numpy(np.array(x)), 4, scaling=scaling).levels


def test_conv_leaves_bucket_in_flax_layout(jx):
    # bucketing the OIHW tensor as it lies would put other weights in every bucket
    _, _, port = _twin(jx, "wrn", 8)
    params = {n: p.detach().clone() for n, p in port.named_parameters()}
    w = params["BasicBlock_2.Conv_1.kernel"]  # [64, 64, 3, 3]: 144 buckets
    got = qt.quantize_tree_hard(params, QuantSpec(bits=2))["BasicBlock_2.Conv_1.kernel"]
    assert got.shape == w.shape
    assert not torch.allclose(got, uniform.fake_quant(w, 2))
    assert torch.equal(got, uniform.fake_quant(w.permute(2, 3, 1, 0), 2).permute(3, 2, 0, 1))


def test_ste_gradient_reaches_oihw_master_weights(jx):
    _, _, port = _twin(jx, "wrn", 8)
    params = {n: p.detach().clone().requires_grad_(True) for n, p in port.named_parameters()}
    q = qt.ste_quantize_tree(params, QuantSpec(bits=2))
    assert q["BatchNorm_0.weight"] is params["BatchNorm_0.weight"]
    assert q["conv_init.kernel"].shape == params["conv_init.kernel"].shape
    sum(t.sum() for t in q.values()).backward()
    assert all(torch.equal(p.grad, torch.ones_like(p)) for p in params.values())


# -------------------------------------------------------------- train step


def _jax_grads(jx, jm, jv, teacher, tv, batch, quant, distill):
    task = jx.tasks.vision_task(jm, teacher, tv)
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        q = jx.trainer.quantized_params(params, quant, None, None)
        logits, upd = task.student_forward({"params": q, "batch_stats": jv["batch_stats"]}, jb,
                                           True, {"dropout": jx.jax.random.PRNGKey(0)})
        loss, metrics = task.loss_and_metrics(logits, task.teacher_forward(jb), jb, distill)
        return loss, (metrics, upd)

    (loss, (metrics, upd)), grads = jx.jax.jit(jx.jax.value_and_grad(loss_fn, has_aux=True))(
        jv["params"])
    return float(loss), metrics, flatten_tree(jx.jax.tree.map(np.asarray, grads)), upd


def test_ste_kd_step_matches_jax(jx):
    """A WRN (strided blocks at an even size): loss, gradients
    (``loss_and_grads``), then two SGD steps of ``make_train_step``:
    metrics, updated weights and running statistics, and the eval step on
    the hard-quantized weights."""
    jm, jv, port = _twin(jx, "wrn", 8)
    jt, tv, teacher = _twin(jx, "cnn", 8, seed=5)
    batch = _images(3, 8)
    quant, jquant = QuantSpec(bits=4), jx.Quant(bits=4)
    distill, jdistill = DistillSpec(0.5, 2.0), jx.Distill(0.5, 2.0)
    task = vision_task(port, teacher, device="cpu")
    jloss, jmetrics, jgrads, jupd = _jax_grads(jx, jm, jv, jt, tv, batch, jquant, jdistill)
    params = {n: p.detach().clone().requires_grad_(True) for n, p in port.named_parameters()}
    stats = {n: t.clone() for n, t in port.named_buffers()}
    loss, metrics, grads, upd = loss_and_grads(
        task, params, as_batch(batch, torch.device("cpu")), quant=quant, distill=distill,
        batch_stats=stats)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(jmetrics["accuracy"]))
    got = flatten_tree(params_to_numpy(grads))
    assert got.keys() == jgrads.keys()
    for path, want in jgrads.items():
        tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got[path], want, rtol=0, atol=tol, err_msg=path)
    want_stats = flatten_tree(jx.jax.tree.map(np.asarray, jupd["batch_stats"]))
    for path, w in flatten_tree(batch_stats_to_numpy(upd["batch_stats"])).items():
        _close(w, want_stats[path], path)

    jtx = jx.trainer.build_optimizer(jx.TrainConfig(**SGD))
    jstate = jx.trainer.create_train_state(jv["params"], jtx, batch_stats=jv["batch_stats"],
                                           quant=jquant)
    jtask = jx.tasks.vision_task(jm, jt, tv)
    jstep = jx.trainer.make_train_step(jtask, jtx, quant=jquant, distill=jdistill, donate=False)
    tx = build_optimizer(TrainConfig(**SGD))
    state = create_train_state(dict(port.named_parameters()), tx,
                               batch_stats=dict(port.named_buffers()), quant=quant, device="cpu")
    step = make_train_step(task, tx, quant=quant, distill=distill, device="cpu")
    for _ in range(2):
        jstate, jm_ = jstep(jstate, {k: jx.jnp.asarray(v) for k, v in batch.items()},
                            jx.jax.random.PRNGKey(0))
        state, m = step(state, batch, 0)
        assert set(m) == set(jm_) == {"loss", "grad_norm", "accuracy"}
        for k in jm_:
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=LOSS_RTOL, err_msg=k)
    # the step updated the model's own weights and statistics in place
    assert all(state.batch_stats[n] is t for n, t in port.named_buffers())
    for got, want in ((params_to_numpy(state.params), jstate.params),
                      (batch_stats_to_numpy(state.batch_stats), jstate.batch_stats)):
        want = flatten_tree(jx.jax.tree.map(np.asarray, want))
        for path, w in flatten_tree(got).items():
            _close(w, want[path], path, rtol=W_RTOL, atol=W_ATOL)
    jeval = jx.trainer.make_eval_step(jtask, quant=jquant)
    ev = make_eval_step(task, quant=quant, device="cpu")
    batches = [_images(7, 8), _images(8, 8, b=3)]
    want = jx.loops.evaluate(jeval, jstate, batches)
    got = evaluate(ev, state, batches)
    assert set(got) == set(want) == {"accuracy"}
    np.testing.assert_allclose(got["accuracy"], want["accuracy"])


def test_joint_codebook_step_on_a_wrn_matches_jax(jx):
    jm, jv, port = _twin(jx, "wrn", 9)
    jt, tv, teacher = _twin(jx, "cnn", 9, seed=5)
    batch = _images(4, 9)
    quant, jquant = QuantSpec(bits=4, method="codebook"), jx.Quant(bits=4, method="codebook")
    jtx = jx.trainer.build_optimizer(jx.TrainConfig(**SGD))
    jstate = jx.trainer.create_train_state(jv["params"], jtx, batch_stats=jv["batch_stats"],
                                           quant=jquant, mode="joint", codebook_init="quantile")
    jstep = jx.trainer.make_train_step(jx.tasks.vision_task(jm, jt, tv), jtx, quant=jquant,
                                       distill=jx.Distill(0.5, 2.0), mode="joint", donate=False)
    tx = build_optimizer(TrainConfig(**SGD))
    state = create_train_state(dict(port.named_parameters()), tx,
                               batch_stats=dict(port.named_buffers()), quant=quant,
                               mode="joint", codebook_init="quantile", device="cpu")
    assert list(state.codebooks) == list(jstate.codebooks)
    step = make_train_step(vision_task(port, teacher, device="cpu"), tx, quant=quant,
                           distill=DistillSpec(0.5, 2.0), mode="joint", device="cpu")
    n0 = fake_quant_buckets.launches
    jstate, jm_ = jstep(jstate, {k: jx.jnp.asarray(v) for k, v in batch.items()},
                        jx.jax.random.PRNGKey(0))
    state, m = step(state, batch, 0)
    assert fake_quant_buckets.launches == n0
    for k in jm_:
        np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=LOSS_RTOL, err_msg=k)
    for path, w in jstate.codebooks.items():
        _close(state.codebooks[path].detach(), w, path, rtol=W_RTOL, atol=W_ATOL)
    for got, want in ((params_to_numpy(state.params), jstate.params),
                      (batch_stats_to_numpy(state.batch_stats), jstate.batch_stats)):
        want = flatten_tree(jx.jax.tree.map(np.asarray, want))
        for path, w in flatten_tree(got).items():
            _close(w, want[path], path, rtol=W_RTOL, atol=W_ATOL)


def test_codebooks_mode_freezes_weights_not_statistics(jx):
    _, _, port = _twin(jx, "wrn", 8)
    _, _, teacher = _twin(jx, "cnn", 8, seed=5)
    quant = QuantSpec(bits=4, method="codebook")
    tx = build_optimizer(TrainConfig(learning_rate=1e-2))
    state = create_train_state(dict(port.named_parameters()), tx,
                               batch_stats=dict(port.named_buffers()), quant=quant,
                               mode="codebooks", device="cpu")
    w0 = {n: p.detach().clone() for n, p in state.params.items()}
    s0 = {n: t.clone() for n, t in state.batch_stats.items()}
    step = make_train_step(vision_task(port, teacher, device="cpu"), tx, quant=quant,
                           distill=DistillSpec(), mode="codebooks", device="cpu")
    state, _ = step(state, _images(6, 8), 0)
    assert all(torch.equal(state.params[n], w0[n]) for n in w0)
    assert all(not torch.equal(state.batch_stats[n], s0[n]) for n in s0)


def test_cnn_dropout_is_seeded_and_training_decreases_loss():
    student = make_cnn("student_small", image_size=16, device="cpu", seed=1)
    x = torch.randn(4, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    params = dict(student.named_parameters())
    a1, _ = student.forward_with(params, x, train=True, generator=torch.Generator().manual_seed(3))
    a2, _ = student.forward_with(params, x, train=True, generator=torch.Generator().manual_seed(3))
    a3, _ = student.forward_with(params, x, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a1, a2) and not torch.allclose(a1, a3)
    teacher = make_cnn("student_medium", image_size=16, device="cpu", seed=2)
    quant = QuantSpec(bits=4)
    tx = build_optimizer(TrainConfig(learning_rate=3e-3))
    state = create_train_state(dict(student.named_parameters()), tx,
                               batch_stats=dict(student.named_buffers()), quant=quant,
                               device="cpu")
    step = make_train_step(vision_task(student, teacher, device="cpu"), tx, quant=quant,
                           distill=DistillSpec(weight=0.1), device="cpu")
    batch = _images(9, 16, b=16)
    out = []
    for _ in range(8):
        state, m = step(state, batch, 0)
        out.append(float(m["loss"]))
    assert out[-1] < out[0] and all(map(math.isfinite, out))


def test_vision_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    for make in (lambda **kw: make_wrn("student_small", **kw),
                 lambda **kw: make_cnn("student_small", **kw),
                 lambda **kw: make_resnet("resnet18_quarter", 10, small_inputs=True, **kw)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    m = make_cnn("student_small", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        vision_task(m)
    vision_task(m, device="cpu")


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["wrn", "resnet_imagenet_stem", "cnn"])
def test_gpu_ste_step_launches_fake_quant_once_and_matches_cpu(cuda, family):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = _images(10, 9)
    runs = {}
    for dev in ("cpu", "cuda"):
        student = _port_model(family, 9, device=dev, seed=1)
        teacher = make_cnn("student_small", CLASSES, image_size=9, device=dev, seed=2)
        tx = build_optimizer(TrainConfig(**SGD))
        state = create_train_state(dict(student.named_parameters()), tx,
                                   batch_stats=dict(student.named_buffers()),
                                   quant=QuantSpec(bits=4), device=dev)
        step = make_train_step(vision_task(student, teacher, device=dev), tx,
                               quant=QuantSpec(bits=4), distill=DistillSpec(0.5, 2.0),
                               device=dev)
        n0 = fake_quant_buckets.launches
        state, m = step(state, batch, 0)
        runs[dev] = (state, m, fake_quant_buckets.launches - n0)
    assert runs["cuda"][2] == 1 and runs["cpu"][2] == 0
    for k, v in runs["cpu"][1].items():
        np.testing.assert_allclose(float(runs["cuda"][1][k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    for attr in ("params", "batch_stats"):
        for n, t in getattr(runs["cpu"][0], attr).items():
            np.testing.assert_allclose(getattr(runs["cuda"][0], attr)[n].detach().cpu().numpy(),
                                       t.detach().numpy(), rtol=W_RTOL, atol=W_ATOL, err_msg=n)
