"""The port's routed phases with one HashMem shard a rank, over
``torch.distributed`` (``RankMesh``, ``launch/mesh.py``), on the CPU.

ONE gloo world of 4 spawned CPU processes runs every ``CASES`` table of
``tests/rlu_cases.py`` (each rank: its shard from the ranked
``build_sharded``, then ``probe_sharded``, ``delete_sharded``,
``insert_mesh`` and ``tick_mesh`` on its own source block, at the
worst-case cap, the measured cap and one below the need) and
``insert_sharded`` with rebuild growth; then its first two ranks, as a
mesh of 2 (``sub_mesh``), run four of the tables and ``insert_sharded``
with extendible splits and a doubling.  Meanwhile the JAX side of
``tests/rlu_cases.py`` runs once (a few subprocesses).  The ranks' outputs,
concatenated in rank order, and each rank's leaves must equal
JAX's (4-device ``shard_map``) bit for bit at every cap at or above the
need, and the stacked backend's at every cap; ``insert_sharded`` must
equal JAX's host-level one (run here, no mesh) in ``ok``, ``cfg'``,
events and leaves.  Tolerance 0: all state is uint32 or int32."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashmap as jhm
from repro.core import rlu as jrlu

from repro_torch.launch.mesh import spawn_ranks

from rank_cases import (TICK_KEYS, extendible_case, grow_case, rlu_world,
                        stacked_case)
from rlu_cases import CASES, finish_jax_side, kill_jax_side, start_jax_side
from hashmap_cases import jax_leaves, jcfg
from rlu_parity_cases import j_build_sharded, j_grow, padded_insert_with_buckets
import torch_threads

one_thread = torch_threads.one_thread

D = 4
NAMES_D2 = ("ref", "perf", "displaced", "overflowed")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(JAX's outputs, the world of 4's rank results, its mesh of 2's,
    JAX's host-level insert_sharded steps by scenario).  The JAX side and
    the world run while this process runs JAX's host-level
    ``insert_sharded``."""
    procs = start_jax_side(str(tmp_path_factory.mktemp("ranks")))
    try:
        with ThreadPoolExecutor(1) as ex:
            world = ex.submit(spawn_ranks, rlu_world, D, list(CASES),
                              NAMES_D2, device="cpu", timeout=300)
            host = {"grow": _jax_grow(), "extendible": _jax_extendible()}
            world = world.result()
    except BaseException:
        kill_jax_side(procs)
        raise
    return (finish_jax_side(procs), [r[4] for r in world],
            [r[2] for r in world[:2]], host)


def joined(ranks, key):
    """The ranks' blocks of one output, in rank order: the whole batch."""
    return np.concatenate([r["cases"][key] for r in ranks])


def assert_rank_leaves(ranks, pre, want):
    """Rank r's leaves under ``pre`` equal leaf r of ``want(name)``."""
    for r, res in enumerate(ranks):
        got = {k[len(pre) + 1:]: v for k, v in res["cases"].items()
               if k.startswith(pre + "/")
               and k[len(pre) + 1:] not in TICK_KEYS}
        assert got, pre
        for n, a in got.items():
            np.testing.assert_array_equal(a, want(n)[r:r + 1],
                                          err_msg=f"rank {r} {pre}/{n}")


@pytest.mark.parametrize("name", list(CASES))
def test_rank_phases_match_jax(name, worlds):
    jax_out, ranks = worlds[:2]
    caps = list(jax_out[f"{name}/caps"])
    assert_rank_leaves(ranks, f"{name}/build",
                       lambda n: jax_out[f"{name}/build/{n}"])
    for cname, jcap in (("none", None), ("need", caps[0])):
        got_v = joined(ranks, f"{name}/probe_{cname}/v").astype(np.uint32)
        np.testing.assert_array_equal(got_v, jax_out[f"{name}/probe{jcap}/v"])
        np.testing.assert_array_equal(joined(ranks, f"{name}/probe_{cname}/f"),
                                      jax_out[f"{name}/probe{jcap}/f"])
    np.testing.assert_array_equal(joined(ranks, f"{name}/delete_none/f"),
                                  jax_out[f"{name}/delete_found"])
    assert_rank_leaves(ranks, f"{name}/delete_none",
                       lambda n: jax_out[f"{name}/delete/{n}"])
    np.testing.assert_array_equal(joined(ranks, f"{name}/insert_need/ok"),
                                  jax_out[f"{name}/insert_ok"])
    assert_rank_leaves(ranks, f"{name}/insert_need",
                       lambda n: jax_out[f"{name}/insert/{n}"])
    for k in TICK_KEYS:
        got = joined(ranks, f"{name}/tick_need/{k}")
        np.testing.assert_array_equal(
            got.astype(np.uint32) if k == "v" else got,
            jax_out[f"{name}/tick_{k}"], err_msg=k)
    assert_rank_leaves(ranks, f"{name}/tick_need",
                       lambda n: jax_out[f"{name}/tick/{n}"])
    assert joined(ranks, f"{name}/tick_need/f").any()


@pytest.mark.parametrize("world", [4, 2])
def test_rank_phases_match_the_stacked_backend_at_every_cap(world, worlds):
    """Every cap, the one below the need included (where the port keeps the
    last in-capacity entry that JAX's unfused route loses)."""
    ranks = worlds[1] if world == 4 else worlds[2]
    dropped = 0
    for name in (list(CASES) if world == 4 else NAMES_D2):
        want = stacked_case(name, world)
        for key, a in want.items():
            pre, n = key.rsplit("/", 1)
            if n in TICK_KEYS:                  # an output
                np.testing.assert_array_equal(joined(ranks, f"{name}/{key}"),
                                              a, err_msg=f"{name}/{key}")
            else:                               # a leaf: rank r's is leaf r
                for r, res in enumerate(ranks):
                    np.testing.assert_array_equal(
                        res["cases"][f"{name}/{key}"], a[r:r + 1],
                        err_msg=f"rank {r} {name}/{key}")
        dropped += int(want["probe_need/f"].sum()
                       - want["probe_below/f"].sum())
    assert dropped > 0, "no cap below the need dropped an entry"


def _jax_insert_sharded(steps_in, D, sb, cfg, hs):
    """JAX's host-level insert_sharded over ``steps_in`` batches, its two
    module loops jitted as ``tests/rlu_parity_cases.py`` jits them: per
    step (ok, cfg', events so far, stacked leaves)."""
    out, ev, jc = [], {}, jcfg(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhm, "insert_with_buckets", padded_insert_with_buckets)
        mp.setattr(jhm, "grow", j_grow)
        for k, v in steps_in:
            hs, ok, jc = jrlu.insert_sharded(hs, jnp.asarray(k),
                                             jnp.asarray(v), jc, D,
                                             shard_by=sb, events=ev)
            out.append((np.asarray(ok), dataclasses.asdict(jc), dict(ev),
                        jax_leaves(hs)))
    return out


def _assert_insert_sharded(ranks, want):
    for r, res in enumerate(ranks):
        assert len(res["insert"]) == len(want)
        for (ok, cfg, ev, lv), (jok, jc, jev, jlv) in zip(res["insert"],
                                                          want):
            np.testing.assert_array_equal(ok, jok)
            assert cfg == jc and ev == jev, (cfg, jc, ev, jev)
            assert set(lv) == set(jlv)
            for n in lv:
                np.testing.assert_array_equal(lv[n], jlv[n][r:r + 1],
                                              err_msg=f"rank {r} {n}")


def _jax_grow():
    cfg, k0, k1 = grow_case()
    hs = j_build_sharded(jcfg(cfg), jnp.asarray(k0), jnp.asarray(k0 * 2), D)
    return _jax_insert_sharded([(k1, k1 * 2)], D, "mod", cfg, hs)


def _jax_extendible():
    cfg, batches = extendible_case()
    hs = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[jhm.create(jcfg(cfg)) for _ in range(2)])
    return _jax_insert_sharded([(k, k + 1) for k in batches], 2, "highbits",
                               cfg, hs)


def test_rank_insert_sharded_grows_every_shard_as_jax(worlds):
    want = worlds[3]["grow"]
    _assert_insert_sharded(worlds[1], want)
    ok, cfg2, ev, _ = want[-1]
    assert ok.all() and ev.get("rebuilds", 0) >= 1
    assert cfg2["num_buckets"] > grow_case()[0].num_buckets


def test_rank_insert_sharded_extendible_splits_and_doubles_as_jax(worlds):
    want = worlds[3]["extendible"]
    _assert_insert_sharded(worlds[2], want)
    ev = want[-1][2]
    assert ev.get("splits", 0) > 0 and ev.get("doublings", 0) > 0, ev
    assert ev.get("rebuilds", 0) == 0, ev
