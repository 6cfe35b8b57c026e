"""The comparison fails what it must: a run of each tiny cell, past the
harness's look for a card, with the timed path broken underneath, comes
out not correct, once for each fault the cell can have; and each cell's
control, put in the program's place, reads past a limit."""

import dataclasses
import functools
import sys
import types

import pytest
import torch

import tiny
from portbench import harness
from quantized_distillation_tpu_torch import serve
from quantized_distillation_tpu_torch.serve import beam, infer
from quantized_distillation_tpu_torch.train import tasks, trainer

SERVE, TRAIN = ["nmt-serve-offline"], ["nmt-kd-train", "lm-kd-train", "nmt-kd-train-dp4"]


def outcome(workload, **kw):
    return tiny.run(tiny.cell(workload), **kw)


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_sound_run_correct(workload):
    assert harness.correct(outcome(workload))


def test_token_altered(monkeypatch):
    real = beam.reconstruct_tokens

    def altered(sym, parent, k):
        toks = real(sym, parent, k).clone()
        toks[..., 1] = (toks[..., 1] + 1) % 60 + 4
        return toks

    monkeypatch.setattr(beam, "reconstruct_tokens", altered)
    assert not harness.correct(outcome("nmt-serve-offline"))


def test_decoder_state_unchanged(monkeypatch):
    real = infer._decode_body

    def stuck(dec, state, *args):
        _, attn_h, align = real(dec, state, *args)
        return state, attn_h, align

    monkeypatch.setattr(infer, "_decode_body", stuck)
    assert not harness.correct(outcome("nmt-serve-offline"))


def test_half_the_batch_left_out_serving(monkeypatch):
    real = serve.beam_search_packed

    def half(model, dec, src, src_len, cfg, **kw):
        n = src.shape[0] // 2
        toks, scores = real(model, dec, src[:n], src_len[:n], cfg, **kw)
        return (torch.cat([toks, torch.zeros_like(toks)]),
                torch.cat([scores, torch.zeros_like(scores)]))

    monkeypatch.setattr(serve, "beam_search_packed", half)
    assert not harness.correct(outcome("nmt-serve-offline"))


def _beam_gap(out):
    return dict((n, (v, lim)) for n, v, lim in out.checks)["beam_gap"]


def test_beam_one(monkeypatch):
    """A search that keeps one beam (greedy decoding) serves hypotheses
    that the reference's beam search beats."""
    real = serve.beam_search_packed

    def greedy(model, dec, src, src_len, cfg, **kw):
        return real(model, dec, src, src_len, dataclasses.replace(cfg, beam_size=1), **kw)

    monkeypatch.setattr(serve, "beam_search_packed", greedy)
    out = outcome("nmt-serve-offline")
    value, limit = _beam_gap(out)
    assert value > limit and not harness.correct(out)


def _state_unchanged(patch):
    patch(trainer, "apply_updates", lambda params, updates: None)


def _half_batch(patch):
    real = tasks.distillation_loss

    def half(student, teacher, labels, spec, mask=None, mp=None):
        n = labels.shape[0] // 2
        return real(student[:n], None if teacher is None else teacher[:n], labels[:n], spec,
                    None if mask is None else mask[:n], mp)

    patch(tasks, "distillation_loss", half)


def _no_exchange(patch):
    patch(trainer, "reduce_over_data",
          lambda loss, metrics, grads, updates, mesh, dtype: (loss, metrics, grads, updates))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


def faulty_rank(fault, *args):
    """A rank of the four-card path with ``fault`` planted in its process."""
    from portbench.paths import train_kd_dp

    FAULTS[fault](setattr)
    return train_kd_dp._rank(*args)


def planted(monkeypatch, workload, fault):
    if tiny.cell(workload).chips > 1:
        from portbench.paths import train_kd_dp

        monkeypatch.setattr(train_kd_dp, "RANK", functools.partial(faulty_rank, fault))
    else:
        FAULTS[fault](monkeypatch.setattr)
    return outcome(workload)


@pytest.mark.parametrize("workload", TRAIN)
def test_state_unchanged(monkeypatch, workload):
    out = planted(monkeypatch, workload, "state_unchanged")
    assert not harness.correct(out)
    assert dict((n, v) for n, v, _ in out.checks)["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out_training(monkeypatch, workload):
    assert not harness.correct(planted(monkeypatch, workload, "half_batch"))


def jax_in_rank(*args):
    """A rank of the four-card path that loads a module named ``jax``."""
    from portbench.paths import train_kd_dp

    sys.modules["jax"] = types.ModuleType("jax")
    return train_kd_dp._rank(*args)


def test_jax_loaded_in_a_rank(monkeypatch):
    """A rank that holds JAX once its window has closed is reported, and
    the run then prints no result and fails."""
    from portbench import run
    from portbench.paths import train_kd_dp

    monkeypatch.setattr(train_kd_dp, "RANK", jax_in_rank)
    out = outcome("nmt-kd-train-dp4")
    assert out.loaded == ["jax"]
    assert "jax" not in sys.modules

    class Path:
        @staticmethod
        def run(*args, **kw):
            return out

    monkeypatch.setattr(run, "_caches", lambda: None)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run.importlib, "import_module", lambda name: Path)
    monkeypatch.setattr(run, "load_cell", lambda workload: tiny.cell("nmt-kd-train-dp4"))
    assert run.main(["--workload", "nmt-kd-train-dp4", "--seed", "1", "--seconds", "1"]) == 3


def test_exchange_left_out(monkeypatch):
    assert not harness.correct(planted(monkeypatch, "nmt-kd-train-dp4", "no_exchange"))


@pytest.mark.parametrize("workload,control", [("nmt-serve-offline", "fp8"),
                                              ("nmt-kd-train", "tf32"), ("lm-kd-train", "tf32"),
                                              ("nmt-kd-train-dp4", "tf32")])
def test_control_reads_past_a_limit(workload, control):
    cell = tiny.cell(workload)
    out = tiny.run(cell, control=control)
    readings = {k.split(".")[-1]: v for k, v in out.notes.items()
                if not k.startswith(("half.", "greedy.", "last."))}
    assert any(readings[k] > cell.limits[k] for k in cell.limits), readings
