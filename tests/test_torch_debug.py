"""The port's numeric sanitizers (``utils/debug.py``), as
``tests/test_debug.py`` holds the JAX package's: non-finite sweeps that
name leaves by path, ``checked`` raising on a NaN (in a function and inside
a quantized train step, where it names the leaf), determinism checks both
ways, and gradient health against the JAX package's on the same tree."""

import math

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.ops.uniform import ste_fake_quant
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
    nmt_task,
)
from quantized_distillation_tpu_torch.train.trainer import TrainState
from quantized_distillation_tpu_torch.utils.debug import (
    NonFiniteError,
    assert_deterministic,
    checked,
    find_nonfinite,
    grad_health,
)

torch.set_num_threads(2)


def test_find_nonfinite_names_leaves():
    tree = {
        "ok": torch.ones(3),
        "bad": {"w": torch.tensor([1.0, math.nan]), "b": torch.tensor([math.inf])},
        "ints": torch.ones(2, dtype=torch.int32),  # never flagged
        "seq": [torch.zeros(1), np.array([-np.inf])],
        "none": None,
    }
    assert sorted(find_nonfinite(tree)) == ["bad/b", "bad/w", "seq/1"]
    assert find_nonfinite({"x": torch.zeros(2)}) == []
    state = TrainState(step=1, params={"w": torch.tensor([math.nan])}, opt_state=None)
    assert find_nonfinite(state, prefix="state") == ["state/params/w"]


def test_checked_raises_on_nan():
    g = checked(torch.log)
    torch.testing.assert_close(g(torch.tensor([1.0])), torch.tensor([0.0]))
    with pytest.raises(NonFiniteError) as ei:
        g(torch.tensor([-1.0]))  # log(-1) is NaN
    assert "nan" in str(ei.value).lower()


def test_checked_raises_in_the_backward_pass():
    def f(x):
        y = torch.sqrt(x)  # the gradient at 0 is inf
        (g,) = torch.autograd.grad(y.sum(), x)
        return g

    with pytest.raises(RuntimeError, match="nan|inf|NaN"):
        checked(f)(torch.tensor([0.0, -1.0], requires_grad=True))


def test_checked_on_quantized_train_step():
    """The real 4-bit STE step passes on sane weights, and raises naming the
    loss once a weight is NaN."""
    def step(w):
        q = ste_fake_quant(w, 4)
        return {"loss": torch.sum(q * q)}

    w = torch.randn(300, generator=torch.Generator().manual_seed(0))
    assert math.isfinite(float(checked(step)(w)["loss"]))

    student = make_seq2seq("student_small", 30, 30, hidden=16, embed_dim=8, device="cpu")
    tx = build_optimizer(TrainConfig())
    quant = QuantSpec(bits=4)
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant, device="cpu")
    train_step = checked(make_train_step(nmt_task(student, device="cpu"), tx, quant=quant,
                                         device="cpu"))
    rng = np.random.default_rng(0)
    batch = {"src": rng.integers(4, 30, (2, 4)), "src_len": np.array([4, 3]),
             "tgt_in": rng.integers(1, 30, (2, 3)), "tgt_out": rng.integers(1, 30, (2, 3)),
             "tgt_mask": np.ones((2, 3), np.float32)}
    state, metrics = train_step(state, batch, 0)
    assert math.isfinite(float(metrics["loss"]))
    with torch.no_grad():
        state.params["generator_bias"][3] = math.nan
    with pytest.raises(RuntimeError, match="returned nan"):  # at the backward op
        train_step(state, batch, 0)
    eval_step = checked(make_eval_step(nmt_task(student, device="cpu"), quant=quant,
                                       device="cpu"))
    with pytest.raises(NonFiniteError, match="'nll_sum'"):  # a forward: names the leaf
        eval_step(state, batch)


def test_assert_deterministic_passes_on_a_step():
    def f(x):
        return {"y": torch.cumsum(x, 0) * 3.0, "z": torch.sum(x), "q": ste_fake_quant(x, 4)}

    assert_deterministic(f, torch.arange(300, dtype=torch.float32) / 7)


def test_assert_deterministic_catches_mutation():
    counter = {"n": 0}

    def f(x):
        counter["n"] += 1
        return x + counter["n"]

    with pytest.raises(AssertionError, match="differs"):
        assert_deterministic(f, torch.ones(4))


def test_grad_health_matches_jax():
    import jax.numpy as jnp

    from quantized_distillation_tpu.utils.debug import grad_health as jax_grad_health

    g = {"a": torch.tensor([3.0, 4.0]), "b": torch.zeros(2)}
    h = grad_health(g)
    assert h == pytest.approx({"norm": 5.0, "max_abs": 4.0, "nonfinite": 0.0})
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    for b in ([1.0, 7.5, -2.0], [1.0, np.inf, -np.inf]):
        tree = {"b": np.array(b, np.float32), "w": w}
        got = grad_health({k: torch.from_numpy(v) for k, v in tree.items()})
        want = jax_grad_health({k: jnp.asarray(v) for k, v in tree.items()})
        assert got["nonfinite"] == want["nonfinite"]
        assert got["max_abs"] == want["max_abs"]
        assert got["norm"] == pytest.approx(want["norm"], rel=1e-6)
    got = grad_health({"w": torch.from_numpy(w), "b": torch.tensor([1.0, math.nan])})
    assert got["nonfinite"] == 1.0 and math.isnan(got["max_abs"])
    assert grad_health({}) == {"norm": 0.0, "max_abs": 0.0, "nonfinite": 0.0}
