"""The port's mesh paths one rank a card (``scripts/multicard_smoke.py``),
and what four NCCL ranks need of the launcher, the warm-up and the build.

On the CPU the harness runs with ``--device cpu`` at small widths over 4
gloo ranks (the kernels' plain versions, no graph): every check at meshes
(1, 4), (2, 2) and (4, 1), exit 0 and the closing line; its (2, 2) f32
sharded tokens equal the JAX package's ``beam_search_sharded`` on the
8-device CPU backend on the same weights. ``--device cuda`` without four
cards raises and never starts a rank. ``comm.warm_up`` issues every
collective kind a graph holds over each axis; ``kernels._build.build_all``
builds a library once when two processes ask for it at the same time (a
stand-in ``nvcc``). A ``gpu`` test runs the harness at its full widths
where PyTorch sees at least four cards. JAX is imported inside the test
that needs it.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from quantized_distillation_tpu_torch.kernels import _build
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.parallel import comm, make_mesh
from quantized_distillation_tpu_torch.parallel.launch import run_ranks
from quantized_distillation_tpu_torch.scripts import multicard_smoke as mc
from quantized_distillation_tpu_torch.utils.graphs import GraphCache, release_graphs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MODULE = "quantized_distillation_tpu_torch.scripts.multicard_smoke"
# the vocab spans all four shards of the generator (each 16 x 256 columns
# at model 4), so the vocab-parallel merge has real candidates on every rank
SMALL = ["--preset", "student_small", "--teacher", "student_small", "--vocab", "12388",
         "--batch", "8", "--beam", "3", "--src-len", "4", "--train-batch", "4",
         "--train-steps", "1", "--lm-teacher", "student_small", "--lm-student", "student_small",
         "--lm-vocab", "40", "--lm-batch", "2", "--lm-bptt", "4", "--wrn-teacher",
         "student_small", "--wrn-student", "student_small", "--vision-batch", "2",
         "--vision-size", "8", "--requests", "8", "--timeout", "120"]
MESHES = ["(1, 4)", "(2, 2)", "(4, 1)"]
LEGS = ["dp_f32 (4, 1)", "dp_bf16 (4, 1)", "tp_weights (1, 4)", "tp_joint (1, 4)",
        "tp_weights (2, 2)", "tp_joint (2, 2)", "lm_tp (2, 2)", "wrn_dp (4, 1)"]


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """The harness over 4 gloo ranks at small widths → (the process, its
    report)."""
    out = tmp_path_factory.mktemp("multicard") / "report.json"
    proc = subprocess.run([sys.executable, "-m", MODULE, "--cards", "4", "--device", "cpu",
                           *SMALL, "--out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    report = json.loads(out.read_text()) if out.exists() else None
    return proc, report


def test_cpu_harness_exits_zero_with_its_closing_line(cpu_run):
    proc, report = cpu_run
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["cards"] == 4 and last["device"] == "cpu"
    assert last["meshes"] == [[1, 4], [2, 2], [4, 1]]
    assert report["failed"] == []


@pytest.mark.parametrize("mesh", MESHES)
def test_cpu_harness_checks_the_searches_at_each_mesh(cpu_run, mesh):
    _, report = cpu_run
    s = report["searches"][mesh]
    for label in mc.SEARCHES:
        assert s[label]["ranks_equal"]
        assert s[label]["all_gathers"] == 3 * 4 + 2  # 3 a step over model, 2 over data
    for label in ("f32", "lut_f32"):  # held to the one-process search
        assert s[label]["sentences"] == 8 and s[label]["differing"] == 0
    data = int(mesh.strip("()").split(",")[0])
    for rank in s["kernels"]:
        assert rank["beam_advance_bit_exact"]
        assert rank["rows"] == 8 * 3 // data  # B K / data rows a rank
    assert all(step["idx_equal"] for step in s["step"])


@pytest.mark.parametrize("mesh", MESHES[1:])
def test_cpu_harness_engine_equals_the_offline_search(cpu_run, mesh):
    _, report = cpu_run
    eng = report["searches"][mesh]["engine"]
    assert eng["requests"] == 8 and eng["tokens_equal_offline"]
    assert eng["chunk_with_an_empty_slice"]  # request 0 alone: the other slices idle
    assert "engine" not in report["searches"]["(1, 4)"]


@pytest.mark.parametrize("leg", LEGS)
def test_cpu_harness_holds_each_train_leg(cpu_run, leg):
    _, report = cpu_run
    rec = report["train"][leg]
    assert rec["captures"] == 0  # gloo steps are never graphed
    assert rec["state"]["graph_over_bound"] == 0 and rec["loss"]["graph_over_bound"] == 0
    assert rec["collectives_a_step"]
    if leg.startswith("wrn"):
        assert "one_process" not in rec  # its statistics are the shards' mean
    else:
        one = rec["one_process"]
        assert one["weights_excess_over_rtol"] <= one["atol"]
        assert abs(one["loss"] - one["one_process_loss"]) <= mc.LOSS_RTOL * abs(
            one["one_process_loss"])


def test_cpu_harness_dry_run(cpu_run):
    _, report = cpu_run
    dry = report["dryrun"]
    assert dry["n"] == 4 and dry["backend"] == "gloo" and dry["mesh"] == {"data": 2, "model": 2}
    assert dry["graphed"] == [False] * 4


def test_sharded_tokens_match_jax_at_2x2(cpu_run):
    """The harness's (2, 2) f32 sharded search against the JAX package's
    on 4 of its 8 CPU devices, on the harness's seeded weights."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import BeamConfig as JBeam
    from quantized_distillation_tpu.models import make_seq2seq as jmake
    from quantized_distillation_tpu.parallel import make_mesh as jmesh
    from quantized_distillation_tpu.serve.infer import pack_decoder as jpack
    from quantized_distillation_tpu.serve.sharded import beam_search_sharded as jbeam
    from quantized_distillation_tpu.serve.sharded import shard_decoder as jshard
    from quantized_distillation_tpu_torch.convert import params_to_numpy

    _, report = cpu_run
    a = mc.parse_args(SMALL)
    tree = params_to_numpy(make_seq2seq(a.preset, a.vocab, a.vocab, device="cpu", seed=a.seed))
    m = jmake(a.preset, a.vocab, a.vocab, dropout=0.0)
    v = {"params": jax.tree.map(jnp.asarray, tree)}
    dec = jpack(v["params"], m.cfg, a.bits, compute_dtype=jnp.float32, use_pallas=False)
    mesh = jmesh(2, 2, devices=jax.devices()[:4])
    sdec = jshard(dec, mesh, v["params"]["generator"]["kernel"], v["params"]["generator"]["bias"])
    src, src_len = mc.serve_inputs(a)
    toks, _ = jbeam(m, v, sdec, jnp.asarray(src.numpy(), jnp.int32),
                    jnp.asarray(src_len.numpy(), jnp.int32),
                    JBeam(beam_size=a.beam, max_len=a.src_len), mesh)
    np.testing.assert_array_equal(np.asarray(report["tokens"]["(2, 2)"]["f32"]), np.asarray(toks))


def test_cuda_without_four_cards_raises_and_never_falls_back(monkeypatch):
    def no_ranks(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(mc, "run_ranks", no_ranks)
    with pytest.raises(RuntimeError, match="no card"):
        mc.main(["--device", "cuda", "--cards", "4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="sees 2"):
        mc.main(["--device", "cuda", "--cards", "4"])


def test_nccl_ranks_need_a_card_each():
    with pytest.raises(RuntimeError, match="one rank a card"):
        run_ranks(_noop_rank, 2, backend="nccl")


def _noop_rank(rank, world):
    return rank


def test_warm_up_issues_every_kind_on_every_axis(tmp_path, monkeypatch):
    """One gloo rank, mesh (1, 1): each kind at each warm-up size over data
    and model, none of it recorded in an open budget."""
    issued = []
    op = comm._op
    monkeypatch.setattr(comm, "_op", lambda kind, nbytes, mesh, axis: (
        issued.append((kind, axis, nbytes)), op(kind, nbytes, mesh, axis)))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(1, 1)
        with comm.collective_budget(mesh) as budget:
            comm.warm_up(mesh)
            comm.warm_up(mesh)  # once a mesh
    finally:
        dist.destroy_process_group()
    assert budget.ops == []
    for axis in ("data", "model"):
        kinds = [(k, b) for k, ax, b in issued if ax == axis]
        for n in comm.WARM_SIZES:
            assert ("all-gather", 4 * n) in kinds
            assert ("reduce-scatter", 4 * n) in kinds
            # f32 sum, bf16 sum, f32 max
            assert sorted(b for k, b in kinds if k == "all-reduce" and b in (2 * n, 4 * n)) == [
                2 * n, 4 * n, 4 * n]
    assert len(issued) == 2 * len(comm.WARM_SIZES) * 5


def _build_once(build_dir, cuda_home, start_at):
    _build.BUILD_DIR = Path(build_dir)
    os.environ["CUDA_HOME"] = cuda_home
    time.sleep(max(0.0, start_at - time.time()))
    _build.build_all(["beam_combine"])


def test_two_processes_build_a_kernel_once(tmp_path):
    """A stand-in ``nvcc`` that takes a second and logs each run: two
    processes that build at the same moment run it once between them."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n"
                    f"echo run >> {log}\n"
                    "sleep 1\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    ": > \"$out\"\n")
    nvcc.chmod(0o755)
    ctx = multiprocessing.get_context("spawn")
    start_at = time.time() + 3.0
    procs = [ctx.Process(target=_build_once, args=(str(tmp_path / "build"),
                                                   str(tmp_path / "cuda"), start_at))
             for _ in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    assert log.read_text().splitlines() == ["run"]
    assert len(list((tmp_path / "build").glob("libbeam_combine-*.so"))) == 1


def test_release_graphs_empties_every_cache():
    cache = GraphCache()
    cache._calls["key"] = object()
    release_graphs()
    assert not cache._calls


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


@pytest.mark.gpu
def test_harness_on_four_cards(four_cards, tmp_path):
    proc = subprocess.run([sys.executable, "-m", MODULE, "--cards", "4"], cwd=REPO,
                          capture_output=True, text=True, timeout=3000)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["cards"] == 4


def test_chip_smoke_phase_22_prints_one_line_below_four_cards(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    checks = chip_smoke.Checks()
    assert chip_smoke.phase_multi_card(checks, "H100, 700 W") == {}
    assert capsys.readouterr().out.splitlines() == [
        json.dumps({"phase": "multi_card", "ran": False, "cards": 1})]
    assert checks.failed == []


def test_chip_smoke_phase_22_reads_the_harness_report(monkeypatch, cpu_run, capsys):
    """With four cards the phase runs the harness (here its CPU report
    stands in for the card's) and returns each kernel's launches a rank."""
    import chip_smoke

    report = json.loads(json.dumps(cpu_run[1]))  # a copy: the fixture is shared
    for mesh in report["searches"].values():  # as the card counts them
        mesh["f32"]["launches_a_rank"][0]["dequant_matmul"] = 72
    calls = []

    def run_script(checks, name, argv, timeout):
        calls.append((name, argv))
        Path(argv[argv.index("--out") + 1]).write_text(json.dumps(report))
        return {"rc": 0, "seconds": 1.0, "last_lines": ["{\"ok\": true}"]}

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(chip_smoke, "run_script", run_script)
    launches = chip_smoke.phase_multi_card(chip_smoke.Checks(), "H100, 700 W")
    assert calls[0][0] == "multicard_smoke" and calls[0][1][:2] == ["--cards", "4"]
    assert launches == {"dequant_matmul": {f"{m} f32": [72, 0, 0, 0] for m in MESHES}}
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "multi_card" and line["ran"] is True and line["cards"] == 4
