"""The serving engine with one HashMem shard a rank (``ServingEngine(mesh=
RankMesh)``), over gloo on the CPU: no JAX corpus.  The stacked mesh engine
is already equal to the host engine and the JAX engine
(``tests/test_torch_serving_mesh.py``, ``test_torch_serving_parity_*.py``),
so every rank's engine is held against it on the same streams: results,
``record_schedule`` logs, the snapshot and stats without their clock
fields (per-shard stats and chain samples gathered from the ranks) and, for
rank r, leaf r of the stacked table; the schedule replays against the
``DictModel``.  One world of 4 ranks (one spawn), and its first two ranks
as a mesh of 2 (``sub_mesh``), run ``perf`` and ``bitserial`` tables fused
and unfused at depth 1 and 2, the per-request baseline, a tiny table that
grows and an extendible one that splits.  One
case runs the ``--mode kv --mesh-shards 2 --ranks`` CLI on the CPU.
Tolerance 0."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch.mesh import make_serving_mesh, spawn_ranks
from repro_torch.launch.serve import serve_kv

from model import DictModel, replay_schedule_against_model
from rank_cases import ENGINE_CASES, engine_case, run_engine_case, \
    serving_world
import torch_threads

one_thread = torch_threads.one_thread

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds():
    """{D: each rank's results by case} on meshes of 4 and 2 ranks."""
    ranks = spawn_ranks(serving_world, 4, ENGINE_CASES, device="cpu",
                        timeout=300)
    return {D: [r[D] for r in ranks[:D]] for D in WORLDS}


@pytest.mark.parametrize("name", ENGINE_CASES)
@pytest.mark.parametrize("D", WORLDS)
def test_rank_engine_equals_the_stacked_engine(D, name, worlds):
    want = run_engine_case(name, make_serving_mesh(D, device="cpu"), "cpu")
    res, sched, snap, st, leaves, calls = want
    for r, got in enumerate(worlds[D]):
        g_res, g_sched, g_snap, g_st, g_leaves, g_calls = got[name]
        assert g_res == res, f"rank {r}: results differ"
        assert g_sched == sched, f"rank {r}: schedules differ"
        assert g_snap == snap, f"rank {r}: snapshots differ"
        assert g_st == st, f"rank {r}: stats differ"
        assert g_calls == calls
        assert set(g_leaves) == set(leaves)
        for n, a in g_leaves.items():
            np.testing.assert_array_equal(a, leaves[n][r:r + 1],
                                          err_msg=f"rank {r} {n}")
    _, _, preload, _ = engine_case(name)
    model = DictModel()
    if preload is not None:
        model.insert(*preload, np.ones(len(preload[0]), bool))
    replay_schedule_against_model(worlds[D][0][name][1], model)
    if name == "grows":
        assert st["grow_events"] > 0
    if name == "extendible":
        assert st["split_events"] > 0 and st["grow_events"] == 0
    if "fused" in name and "unfused" not in name:
        assert calls["fused_tick"] > 0 and calls["probe"] == 0


def test_serve_cli_over_two_ranks_on_the_cpu():
    """``--mode kv --mesh-shards 2 --ranks``: two rank processes, one
    printed report, equal to the stacked CLI run's but for the clocks."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    args = ["--mode", "kv", "--device", "cpu", "--workloads", "A,B",
            "--requests", "32", "--slots", "8", "--mesh-shards", "2"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args, "--ranks"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count('"total_ops"') == 1, proc.stdout[-2000:]
    got = json.loads(proc.stdout)
    _, snap = serve_kv(workloads="A,B", requests=32, slots=8, mesh_shards=2,
                       verbose=False, device="cpu")
    for k in ("total_ops", "ticks", "requests_completed"):
        assert got[k] == snap[k], k
    assert got["total_ops"] > 0 and got["engine"]["mesh_backed"]
    assert len(got["engine"]["shards"]) == 2


@pytest.mark.parametrize("kw, err", [
    (dict(backend="nccl", device="cpu"), ValueError),
    (dict(backend="mpi", device="cpu"), ValueError),
    (dict(backend="gloo", device=None), RuntimeError),
], ids=["nccl_on_cpu", "unknown_backend", "no_card"])
def test_rank_mesh_refuses_what_it_cannot_run(kw, err, tmp_path):
    """Checked before joining a world: nccl needs a card a rank, the
    backend is named, and ``device=None`` is the card, which must be
    there.  Nothing falls back."""
    import torch
    from repro_torch.launch.mesh import make_rank_mesh
    if kw["device"] is None and torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(err):
        make_rank_mesh(2, 0, f"file://{tmp_path}/store", **kw)


def test_a_failing_rank_makes_spawn_ranks_raise():
    from rank_cases import fail_on_rank_one
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn_ranks(fail_on_rank_one, 2, device="cpu", timeout=60)
