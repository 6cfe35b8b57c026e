"""The port's spans and counters (``utils.tracing``).

Spans are record functions of the profiler's function scope, named
``qdt.<name>``, and only while a profiler records: the CPU tests profile a
train step and the searches and read the spans' nesting and order from
the profiler's own events; with no profiler a span makes no record
function at all. Counters: ``count`` / ``counts``, which also carries the
kernels' launch counters. Tests marked ``gpu`` count a ``GraphCache``'s
captures, replays and evictions and a ``CapturedStep``'s replays, and hold
that no span leaves a range on the device's timeline; they skip where
PyTorch sees no card.
"""

import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quantized_distillation_tpu_torch.config import BeamConfig, DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.convert import params_to_numpy
from quantized_distillation_tpu_torch.kernels import launch_counts
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.serve import beam_search, beam_search_packed, pack_decoder
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    make_train_step,
    nmt_task,
)
from quantized_distillation_tpu_torch.utils import tracing
from quantized_distillation_tpu_torch.utils.graphs import CapturedStep, GraphCache

V = 30


def _spans(prof, device_type=None):
    """(name, start, end) of the trace's ``qdt.`` events, by start."""
    from torch.autograd import DeviceType

    want = DeviceType.CPU if device_type is None else device_type
    return sorted((e.name()[len(tracing.PREFIX):], e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(tracing.PREFIX) and e.device_type() == want)


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _nmt_batch(seed, b=3, ts=5, tt=4):
    rng = np.random.default_rng(seed)
    return {"src": rng.integers(4, V, (b, ts)).astype(np.int32),
            "src_len": np.array([ts, ts - 2, 1][:b], np.int32),
            "tgt_in": rng.integers(1, V, (b, tt)).astype(np.int32),
            "tgt_out": rng.integers(1, V, (b, tt)).astype(np.int32),
            "tgt_mask": np.ones((b, tt), np.float32)}


def _train_step():
    student = make_seq2seq("student_small", V, V, hidden=16, embed_dim=8, device="cpu", seed=1)
    teacher = make_seq2seq("student_small", V, V, hidden=16, embed_dim=8, device="cpu", seed=2)
    tx = build_optimizer(TrainConfig(learning_rate=1e-3))
    step = make_train_step(nmt_task(student, teacher, device="cpu"), tx,
                           quant=QuantSpec(bits=4), distill=DistillSpec(0.5, 2.0), device="cpu")
    return step, create_train_state(dict(student.named_parameters()), tx, device="cpu")


def test_train_step_spans_nest_in_order():
    step, state = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, _nmt_batch(0), 0)
    spans = {name: (name, s, e) for name, s, e in _spans(prof)}
    assert set(spans) == {"train.step", "train.prepare", "train.finish"}
    outer, prep, fin = spans["train.step"], spans["train.prepare"], spans["train.finish"]
    assert _within(prep, outer) and _within(fin, outer)
    assert prep[2] <= fin[1]  # prepare ends before finish starts


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_search_is_one_span(packed):
    m = make_seq2seq("student_small", 20, V, hidden=16, embed_dim=8, device="cpu")
    src, sl = torch.ones(2, 3, dtype=torch.long), torch.tensor([3, 2])
    cfg = BeamConfig(beam_size=2, max_len=3)
    if packed:
        dec = pack_decoder(params_to_numpy(m), m.cfg, 4, device="cpu")
        run = lambda: beam_search_packed(m, dec, src, sl, cfg, device="cpu")  # noqa: E731
    else:
        run = lambda: beam_search(m, src, sl, cfg, device="cpu")  # noqa: E731
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tokens, _ = run()
    assert [name for name, _, _ in _spans(prof)] == ["serve.search"]
    assert tokens.shape == (2, 3)


def test_search_entries_keep_their_signatures():
    for fn in (beam_search_packed, beam_search):
        assert "_eager" in inspect.signature(fn).parameters
        assert fn.__name__ in ("beam_search_packed", "beam_search") and fn.__doc__


def test_span_without_a_profiler_makes_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record function {name} made with no profiler")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    with tracing.span("x"):
        pass
    step, state = _train_step()
    step(state, _nmt_batch(1), 0)  # every span of a step, off
    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError):
        tracing.span("x")


def test_span_off_is_one_shared_context():
    assert tracing.span("a") is tracing.span("b")


def test_counters_and_launch_counters():
    before = tracing.counts()
    tracing.count("test.things")
    tracing.count("test.things", 4)
    now = tracing.counts()
    assert now["test.things"] - before.get("test.things", 0) == 5
    assert {f"launch.{n}": c for n, c in launch_counts().items()}.items() <= now.items()
    now["test.things"] = -1  # a copy
    assert tracing.counts()["test.things"] != -1


def test_train_step_eviction_is_counted():
    step, state = _train_step()
    step.SIZE = 1
    before = tracing.counts().get("graph.evictions", 0)
    state, _ = step(state, _nmt_batch(2), 0)
    state, _ = step(state, _nmt_batch(3, b=2), 0)  # a second signature evicts the first
    assert tracing.counts()["graph.evictions"] == before + 1


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _delta(before, *names):
    now = tracing.counts()
    return tuple(now.get(n, 0) - before.get(n, 0) for n in names)


COUNTERS = ("graph.captures", "graph.replays", "graph.evictions")


@pytest.mark.gpu
def test_gpu_graph_cache_counts_captures_and_replays(cuda):
    cache, x = GraphCache(), torch.arange(4.0, device=cuda)
    before = tracing.counts()
    cache.run("double", lambda a: (a * 2,), [x])
    assert _delta(before, *COUNTERS) == (1, 1, 0)  # the first call captures, then replays
    for n in (2, 3):
        (y,) = cache.run("double", lambda a: (a * 2,), [x])
        assert _delta(before, *COUNTERS) == (1, n, 0)
    assert torch.equal(y, x * 2)


@pytest.mark.gpu
def test_gpu_graph_cache_counts_evictions(cuda):
    cache, x = GraphCache(), torch.arange(4.0, device=cuda)
    cache.SIZE = 2
    before = tracing.counts()
    for key in ("a", "b", "c"):
        cache.run(key, lambda a: (a + 1,), [x])
    assert _delta(before, *COUNTERS) == (3, 3, 1)


@pytest.mark.gpu
def test_gpu_captured_step_counts_replays(cuda):
    x = torch.zeros(4, device=cuda)
    before = tracing.counts()
    graphed = CapturedStep(lambda: x.add_(1))
    graphed.replay(3)
    torch.cuda.synchronize()
    assert _delta(before, *COUNTERS) == (1, 3, 0)
    assert torch.equal(x, torch.full_like(x, 4.0))  # the warm-up and three replays


@pytest.mark.gpu
def test_gpu_spans_stay_off_the_device_timeline(cuda):
    from torch.autograd import DeviceType

    cache, x = GraphCache(), torch.arange(4.0, device=cuda)
    cache.run("triple", lambda a: (a * 3,), [x])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span("outer"):
            cache.run("triple", lambda a: (a * 3,), [x])
            cache.run("new", lambda a: (a - 1,), [x])
        torch.cuda.synchronize()
    names = [name for name, _, _ in _spans(prof)]
    assert {"outer", "graph.capture", "graph.inputs", "graph.replay",
            "graph.outputs"} <= set(names)
    assert names.count("graph.replay") == 2 and names.count("graph.capture") == 1
    assert _spans(prof, DeviceType.CUDA) == []
