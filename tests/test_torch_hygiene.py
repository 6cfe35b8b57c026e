"""The PyTorch port stands alone: it loads nothing of JAX, flax or the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "quantized_distillation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "quantized_distillation_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_and_chip_smoke_load_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import quantized_distillation_tpu_torch as q\n"
        "for m in pkgutil.walk_packages(q.__path__, q.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('\\n'.join(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout.split()
    assert "quantized_distillation_tpu_torch.serve.infer" in out
    assert "quantized_distillation_tpu_torch.train.trainer" in out
    assert "quantized_distillation_tpu_torch.utils.metrics" in out
    assert "quantized_distillation_tpu_torch.graft_entry" in out
    assert "quantized_distillation_tpu_torch.bench" in out
    assert "chip_smoke" in out
    assert [m for m in out if _forbidden(m)] == []


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"], ids=lambda p: p.name
)
def test_no_forbidden_import_statements(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}: imports {names}"


def test_entry_points_default_to_the_card():
    from quantized_distillation_tpu_torch.config import BeamConfig
    from quantized_distillation_tpu_torch.convert import params_to_numpy
    from quantized_distillation_tpu_torch.models import make_seq2seq
    from quantized_distillation_tpu_torch.serve.infer import beam_search_packed, pack_decoder

    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    m = make_seq2seq("student_small", 20, 30, hidden=16, embed_dim=8, device="cpu")
    params = params_to_numpy(m)
    with pytest.raises(RuntimeError, match="cuda"):
        make_seq2seq("student_small", 20, 30, hidden=16, embed_dim=8)
    with pytest.raises(RuntimeError, match="cuda"):
        pack_decoder(params, m.cfg, 4)
    dec = pack_decoder(params, m.cfg, 4, device="cpu")
    src, sl = torch.ones(2, 3, dtype=torch.long), torch.tensor([3, 2])
    with pytest.raises(RuntimeError, match="cuda"):
        beam_search_packed(m, dec, src, sl, BeamConfig(beam_size=2, max_len=3))
    toks, scores = beam_search_packed(m, dec, src, sl, BeamConfig(beam_size=2, max_len=3), device="cpu")
    assert toks.shape == (2, 3) and torch.isfinite(scores).all()


def test_train_entry_points_default_to_the_card():
    from quantized_distillation_tpu_torch.config import QuantSpec, TrainConfig
    from quantized_distillation_tpu_torch.models import make_seq2seq
    from quantized_distillation_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        fit,
        make_eval_step,
        make_train_step,
        nmt_task,
    )

    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    m = make_seq2seq("student_small", 20, 30, hidden=16, embed_dim=8, device="cpu")
    cfg = TrainConfig(epochs=1, quant=QuantSpec(bits=4))
    tx = build_optimizer(cfg)  # makes no tensor: its state follows the parameters
    params = dict(m.named_parameters())
    with pytest.raises(RuntimeError, match="cuda"):
        nmt_task(m)
    task = nmt_task(m, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(params, tx)
    state = create_train_state(params, tx, device="cpu")
    for call in (
        lambda: make_train_step(task, tx),
        lambda: make_eval_step(task),
        lambda: fit(task, state, cfg, lambda epoch: []),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    make_train_step(task, tx, device="cpu")
    make_eval_step(task, device="cpu")


def test_graft_entry_points_default_to_the_card():
    from quantized_distillation_tpu_torch import graft_entry

    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.main([])
