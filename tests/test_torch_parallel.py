"""The port's ``parallel/`` (mesh, sharding rules and placement, collectives
and their budget) against the JAX package's on its 8-device CPU mesh.

Ranks are spawned processes of one gloo group (``parallel.launch.run_ranks``:
4 ranks for meshes (2, 2), (1, 4) and (4, 1), 8 for (2, 4) and the 1-, 2-
and 3-dim meshes of ``tests/test_comm.py``); each returns what it holds,
and the tests compare it with JAX in this process:

- ``make_mesh``: rank r at (r // model, r % model), JAX's device layout, and
  the same refusals;
- ``seq2seq_pspecs`` shards the same leaves on the same dims;
- each rank's ``place_params_seq2seq`` / ``place_params_lm`` /
  ``place_batch`` / ``place_replicated`` tensors equal, bit for bit, JAX's
  addressable shard at that mesh position, the divisibility fallback
  included (source vocab 30 does not split 4 ways), for the flax-layout tree
  and for a port model's fused ``named_parameters()``;
- ``_axis_of_groups`` on ``tests/test_comm.py``'s group patterns, and
  ``wire_bytes``, ``bytes_by_axis``, ``format_budget`` and
  ``scaling_estimate`` on the same budgets;
- the collective helpers' results and records.

Also the per-device plan cache of the fused generator (a card's plan
depends on its SM count). JAX is imported only inside the JAX-side code:
the spawned ranks import this module again.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import MeshConfig
from quantized_distillation_tpu_torch.convert import flax_paths, params_from_numpy
from quantized_distillation_tpu_torch.models import Seq2Seq, Seq2SeqConfig, make_lm
from quantized_distillation_tpu_torch.parallel import (
    make_mesh,
    mesh_from_config,
    place_batch,
    place_params_lm,
    place_params_seq2seq,
    place_replicated,
    seq2seq_pspecs,
)
from quantized_distillation_tpu_torch.parallel import comm
from quantized_distillation_tpu_torch.parallel.launch import run_ranks
from quantized_distillation_tpu_torch.parallel.sharding import batch_pspecs, replicated_pspecs

torch.set_num_threads(2)

MESHES4 = [(2, 2), (1, 4), (4, 1)]
MESHES8 = [(2, 4)]
SRC_V, TGT_V, LM_V = 30, 40, 24  # 30 rows do not split 4 ways: replicated there
# tests/test_comm.py's meshes and group patterns
COMM_MESHES = {
    (8,): (("data",), [[list(range(8))], [[0], [1]]]),
    (4, 2): (("data", "model"), [[[0, 1], [2, 3], [4, 5], [6, 7]], [[0, 2, 4, 6], [1, 3, 5, 7]],
                                 [list(range(8))]]),
    (2, 2, 2): (("data", "model", "expert"),
                [[[0, 1], [2, 3], [4, 5], [6, 7]], [[0, 2], [1, 3], [4, 6], [5, 7]],
                 [[0, 4], [1, 5], [2, 6], [3, 7]], [[0, 1, 2, 3]]]),
}


def _flat(tree, prefix=()):
    """Nested dicts → {path tuple: leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _np_tree(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flat(tree).items()}


def _placements(payload, mesh):
    """Everything this rank holds under ``mesh``, as numpy."""
    s2s = payload["seq2seq"]
    model = Seq2Seq(Seq2SeqConfig(**payload["seq2seq_cfg"]), device="cpu").load_params(
        params_from_numpy(s2s))
    lm = make_lm("student_small", LM_V, device="cpu", **payload["lm_kw"]).load_params(
        payload["lm"])
    flat_port = {n: p.detach() for n, p in model.named_parameters()}
    return {
        "tree": _np_tree(place_params_seq2seq(s2s, mesh, device="cpu")),
        "port_names": {n: t.numpy() for n, t in
                       place_params_seq2seq(flat_port, mesh, device="cpu").items()},
        "lm": _np_tree(place_params_lm(payload["lm"], mesh, device="cpu")),
        "lm_port_names": {n: t.detach().numpy() for n, t in place_params_lm(
            dict(lm.named_parameters()), mesh, device="cpu").items()},
        "batch": _np_tree(place_batch(payload["batch"], mesh, device="cpu")),
        "replicated": _np_tree(place_replicated(payload["batch"], mesh, device="cpu")),
        "specs": {"/".join(k): v for k, v in _flat(seq2seq_pspecs(s2s)).items()},
    }


def _collectives(rank, mesh):
    """The helpers over (2, 2): results and what they record."""
    d, m = rank // 2, rank % 2
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    with comm.collective_budget(mesh) as budget:
        gathered = comm.all_gather(x, mesh, "model")
        summed = comm.psum(x / 3, mesh, "data", dtype=torch.float16)
        mean = comm.pmean(x, mesh, "data")
    return {"gathered": gathered.numpy(), "summed": (summed.numpy(), str(summed.dtype)),
            "mean": mean.numpy(), "coord": (d, m),
            "ops": [dataclasses.astuple(op) for op in budget.ops]}


def _rank4(rank, world, payload):
    out = {"meshes": {}, "place": {}}
    for shape in MESHES4:
        mesh = make_mesh(*shape)
        out["meshes"][shape] = (mesh.mesh.tolist(), (mesh.get_local_rank("data"),
                                                     mesh.get_local_rank("model")))
        out["place"][shape] = _placements(payload, mesh)
    inferred = make_mesh(None, 2)
    out["inferred"] = inferred.mesh.tolist()
    out["from_config"] = mesh_from_config(MeshConfig(data=4, model=1)).mesh.tolist()
    msgs = []
    for bad in ((3, 1), (None, 3)):
        try:
            make_mesh(*bad)
        except ValueError as e:
            msgs.append(str(e))
    out["refusals"] = msgs
    out["collectives"] = _collectives(rank, make_mesh(2, 2))
    return out


def _rank8(rank, world, payload):
    from torch.distributed.device_mesh import init_device_mesh

    out = {"meshes": {}, "place": {}, "axes": {}}
    for shape in MESHES8:
        mesh = make_mesh(*shape)
        out["meshes"][shape] = (mesh.mesh.tolist(), (mesh.get_local_rank("data"),
                                                     mesh.get_local_rank("model")))
        out["place"][shape] = _placements(payload, mesh)
    for shape, (names, patterns) in COMM_MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        out["axes"][shape] = [comm._axis_of_groups(g, mesh) for g in patterns]
    return out


@pytest.fixture(scope="module")
def jx():
    import jax

    from quantized_distillation_tpu.models import make_lm as jmake_lm
    from quantized_distillation_tpu.models import make_seq2seq as jmake_s2s

    rng = np.random.default_rng(0)

    def fill(shapes):
        return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)

    s2s = jmake_s2s("student_small", SRC_V, TGT_V, hidden=16, embed_dim=8, num_layers=2)
    shapes = jax.eval_shape(s2s.init, jax.random.PRNGKey(0), np.zeros((1, 3), np.int32),
                            np.ones((1,), np.int32), np.zeros((1, 2), np.int32))
    lm_kw = dict(embed_dim=8, hidden=12, num_layers=2)
    lm = jmake_lm("student_small", LM_V, **lm_kw)
    lm_shapes = jax.eval_shape(lm.init, jax.random.PRNGKey(0), np.zeros((1, 3), np.int32))
    batch = {"src": rng.integers(3, SRC_V, (8, 5)).astype(np.int32),
             "src_len": np.full(8, 5, np.int32),
             "tgt_mask": rng.random((8, 4)).astype(np.float32)}
    return {"jax": jax, "payload": {
        "seq2seq": fill(dict(shapes["params"])), "seq2seq_cfg": dataclasses.asdict(s2s.cfg),
        "lm": fill(dict(lm_shapes["params"])), "lm_kw": lm_kw, "batch": batch,
    }}


@pytest.fixture(scope="module")
def ranks4(jx, tmp_path_factory):
    return run_ranks(_rank4, 4, args=(jx["payload"],), timeout=120, join_timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("ranks4")))


@pytest.fixture(scope="module")
def ranks8(jx, tmp_path_factory):
    return run_ranks(_rank8, 8, args=(jx["payload"],), timeout=120, join_timeout=300,
                     store_dir=str(tmp_path_factory.mktemp("ranks8")))


def _ranks(request, shape):
    return request.getfixturevalue("ranks8" if shape in MESHES8 else "ranks4")


def _jmesh(jx, shape):
    from quantized_distillation_tpu.parallel import make_mesh as jmake_mesh

    return jmake_mesh(*shape, devices=jx["jax"].devices()[: int(np.prod(shape))])


def _shard_of(arr, rank):
    """The data of a JAX array's shard on device ``rank``."""
    (shard,) = [s for s in arr.addressable_shards if s.device.id == rank]
    return np.asarray(shard.data)


@pytest.mark.parametrize("shape", MESHES4 + MESHES8, ids=str)
def test_make_mesh_layout_matches_jax(jx, request, shape):
    want = np.vectorize(lambda d: d.id)(_jmesh(jx, shape).devices).tolist()
    for rank, out in enumerate(_ranks(request, shape)):
        ranks, coord = out["meshes"][shape]
        assert ranks == want
        assert coord == (rank // shape[1], rank % shape[1])


def test_make_mesh_inference_config_and_refusals(ranks4):
    from quantized_distillation_tpu.parallel import make_mesh as jmake_mesh

    for out in ranks4:
        assert out["inferred"] == [[0, 1], [2, 3]]
        assert out["from_config"] == [[0], [1], [2], [3]]
        assert out["refusals"] == ["mesh 3x1 != 4 devices", "4 devices not divisible by model=3"]
    for bad in ((3, 1), (None, 3)):  # the JAX package's messages on 4 devices
        import jax

        with pytest.raises(ValueError) as e:
            jmake_mesh(*bad, devices=jax.devices()[:4])
        assert str(e.value) in ranks4[0]["refusals"]
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1)  # no group in this process: no one-rank mesh either


def test_pspecs_match_jax(jx, ranks4):
    from quantized_distillation_tpu.parallel.sharding import seq2seq_pspecs as jspecs

    want = {"/".join(str(p.key) for p in path): tuple(spec) for path, spec in
            jx["jax"].tree_util.tree_flatten_with_path(
                jspecs(jx["payload"]["seq2seq"]),
                is_leaf=lambda x: type(x).__name__ == "PartitionSpec")[0]}
    assert ranks4[0]["place"][(2, 2)]["specs"] == want
    assert sum(bool(s) for s in want.values()) > 10
    batch = jx["payload"]["batch"]
    assert batch_pspecs(batch) == {k: ("data",) for k in batch}
    assert replicated_pspecs(batch) == {k: () for k in batch}


def _jax_placed(jx, shape, fn_name, tree):
    from quantized_distillation_tpu.parallel import sharding as jsharding

    placed = getattr(jsharding, fn_name)(tree, _jmesh(jx, shape))
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jx["jax"].tree_util.tree_flatten_with_path(placed)[0]}


@pytest.mark.parametrize("shape", MESHES4 + MESHES8, ids=str)
@pytest.mark.parametrize("family", ["seq2seq", "lm"])
def test_param_placement_matches_jax_shards(jx, request, shape, family):
    fn = "place_params_seq2seq" if family == "seq2seq" else "place_params_lm"
    want = _jax_placed(jx, shape, fn, jx["payload"][family])
    key = "tree" if family == "seq2seq" else "lm"
    names = "port_names" if family == "seq2seq" else "lm_port_names"
    sharded = 0
    for rank, out in enumerate(_ranks(request, shape)):
        got = out["place"][shape]
        assert set(got[key]) == set(want)
        for path, arr in want.items():
            shard = _shard_of(arr, rank)
            np.testing.assert_array_equal(got[key][path], shard, err_msg=path)
            sharded += shard.shape != arr.shape
        for name, local in got[names].items():
            # a fused gate tensor: its four flax leaves' shards side by side
            parts = [_shard_of(want[p], rank) for p in flax_paths(name)]
            np.testing.assert_array_equal(local, np.concatenate(parts, axis=-1), err_msg=name)
    assert (sharded > 0) == (shape[1] > 1)  # the rules split over model only
    if family == "seq2seq" and shape[1] == 4:  # 30 source rows do not split 4 ways
        emb = want["encoder/embed/embedding"]
        assert all(s.data.shape == emb.shape for s in emb.addressable_shards)


@pytest.mark.parametrize("shape", MESHES4 + MESHES8, ids=str)
def test_batch_placement_matches_jax_shards(jx, request, shape):
    batch = jx["payload"]["batch"]
    want = _jax_placed(jx, shape, "place_batch", batch)
    rep = _jax_placed(jx, shape, "place_replicated", batch)
    for rank, out in enumerate(_ranks(request, shape)):
        got = out["place"][shape]
        for k in batch:
            np.testing.assert_array_equal(got["batch"][k], _shard_of(want[k], rank))
            assert got["batch"][k].dtype == batch[k].dtype
            np.testing.assert_array_equal(got["replicated"][k], _shard_of(rep[k], rank))


def test_axis_of_groups_matches_jax(ranks8):
    from quantized_distillation_tpu.parallel.comm import _axis_of_groups as jaxis

    class _Dev:
        def __init__(self, i):
            self.id = i

    for shape, (names, patterns) in COMM_MESHES.items():
        fake = types.SimpleNamespace(
            devices=np.array([_Dev(i) for i in range(8)]).reshape(shape), axis_names=names)
        want = [jaxis(g, fake) for g in patterns]
        assert len(set(want)) > 1
        for out in ranks8:
            assert out["axes"][shape] == want


BUDGET_OPS = [("all-reduce", 1000, "data", 4), ("all-gather", 1000, "data", 4),
              ("reduce-scatter", 512, "model", 2), ("all-to-all", 96, "model", 8),
              ("collective-permute", 64, "unknown", 2), ("all-reduce", 4096, "model", 1)]


def test_wire_bytes_budget_and_scaling_match_jax():
    from quantized_distillation_tpu.parallel import comm as jcomm

    jops = [jcomm.CollectiveOp(*op) for op in BUDGET_OPS]
    ops = [comm.CollectiveOp(*op) for op in BUDGET_OPS]
    assert [o.wire_bytes() for o in ops] == [o.wire_bytes() for o in jops]
    assert ops[0].wire_bytes() == 1500 and ops[1].wire_bytes() == 750  # test_comm.py's
    jb, b = jcomm.CommBudget(jops), comm.CommBudget(ops)
    for wire in (True, False):
        assert b.bytes_by_axis(wire) == jb.bytes_by_axis(wire)
    assert comm.format_budget(b) == jcomm.format_budget(jb)
    for kw in (dict(), dict(hosts=4), dict(overlap=True), dict(hosts=8, dcn_bytes_per_s=1e9)):
        assert comm.scaling_estimate(b, 0.01, **kw) == jcomm.scaling_estimate(jb, 0.01, **kw)


def test_collective_helpers_and_their_records(ranks4):
    for rank, out in enumerate(ranks4):
        c = out["collectives"]
        d, m = c["coord"]
        x = lambda r: np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r  # noqa: E731
        np.testing.assert_array_equal(c["gathered"], np.stack([x(2 * d), x(2 * d + 1)]))
        want = (x(m) / 3).astype(np.float16).astype(np.float32) + \
            (x(2 + m) / 3).astype(np.float16).astype(np.float32)
        summed, dtype = c["summed"]
        assert dtype == "torch.float32"  # carried in f16, returned in the input's dtype
        np.testing.assert_allclose(summed, want, rtol=1e-3)
        np.testing.assert_allclose(c["mean"], (x(m) + x(2 + m)) / 2)
        assert c["ops"] == [("all-gather", 2 * 24, "model", 2), ("all-reduce", 12, "data", 2),
                            ("all-reduce", 24, "data", 2)]


def test_generator_plan_cache_is_keyed_by_device(monkeypatch):
    """A card's plan depends on its SM count: a rank on cuda:1 must get
    cuda:1's plan, not one cached from cuda:0."""
    import contextlib

    from quantized_distillation_tpu_torch.kernels import _build, topk_fused
    from quantized_distillation_tpu_torch.kernels.packed import PackedLinear

    sms = {0: 132, 1: 66}
    current = {"device": 0}
    calls = []

    @contextlib.contextmanager
    def on(device):
        prev, current["device"] = current["device"], int(getattr(device, "index", device))
        try:
            yield
        finally:
            current["device"] = prev

    def plan_fn(m, k, n, x_bf16, compute_bf16, lut, bits, plan):
        calls.append(current["device"])
        plan[4] = sms[current["device"]]  # "splits": one wave over the SMs
        return 0

    monkeypatch.setattr(_build, "on", on)
    monkeypatch.setattr(_build, "function", lambda *a: plan_fn)
    topk_fused._plan.cache_clear()
    try:
        p = PackedLinear(packed=torch.zeros(1), scale=torch.zeros(1), offset=torch.zeros(1),
                         bits=4, shape=(256, 8192))
        plans = {}
        for dev in (0, 1, 0, 1):
            x = types.SimpleNamespace(device=torch.device("cuda", dev), shape=(1280, 256),
                                      dtype=torch.bfloat16)
            plans[dev] = topk_fused.dequant_matmul_topk_plan(x, p)
        assert calls == [0, 1]  # each device's plan read once, on that device
        assert plans[0]["splits"] == 132 and plans[1]["splits"] == 66
        assert topk_fused._plan.cache_info().currsize == 2
    finally:
        topk_fused._plan.cache_clear()
