"""Parity of the port's sharded RLU (``repro_torch.core.rlu``) with the JAX
package's, in process: the device routers, the sharded build, the
host-level routed insert in both resize modes, the routing permutation
(``_Route``), ``routing_cap``, and every ``bucket_fn`` entry point of
``hashmap``.  None of these JAX functions needs a mesh.  Tolerance 0: all
state is uint32 or int32 and no float math is on this path.

One case holds the port's deliberate divergence: JAX's unfused route loses
the last in-capacity entry of a destination that overflows an explicit cap
(``src/repro/core/rlu.py:303-305``); the port keeps it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm
from repro.core import rlu as jrlu

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import rlu as trlu

from test_torch_hashmap import assert_same_state, jcfg, jax_leaves

CPU = "cpu"
HASHES = ("murmur3_fmix", "mult_shift", "identity")

j_iwb = jax.jit(jhm.insert_with_buckets)
j_grow = jax.jit(jhm.grow, static_argnames=("factor", "bucket_fn"))
j_build_sharded = jax.jit(jrlu.build_sharded, static_argnums=(0, 3),
                          static_argnames=("shard_by",))
j_compact = jax.jit(jhm.compact, static_argnames=("bucket_fn",))
j_delete_wb = jax.jit(jhm.delete_with_buckets)
j_probe_wb = jax.jit(jhm.probe_with_buckets)
# one JAX bucket_fn per router, so the jitted calls compile once per config
J_BUCKET_FNS = {(D, r): jrlu._local_bucket_fn(D, r) for D in (2, 3)
                for r in ("mod", "highbits")}


def padded_insert_with_buckets(hm, keys, vals, b, valid=None):
    n = keys.shape[0]
    m = max(8, 1 << (n - 1).bit_length())

    def pad(a, fill):
        a = jnp.asarray(a)
        return jnp.concatenate([a, jnp.full((m - n,), fill, a.dtype)])

    v = jnp.ones((n,), bool) if valid is None else jnp.asarray(valid)
    hm2, ok = j_iwb(hm, pad(keys, 0), pad(vals, 0), pad(b, 0), pad(v, False))
    return hm2, ok[:n]


@pytest.fixture
def jitted_jax_loops(monkeypatch):
    """The JAX package's host-level loops with two module functions jitted
    (a padded ``insert_with_buckets`` writes nothing for its pads)."""
    monkeypatch.setattr(jhm, "insert_with_buckets", padded_insert_with_buckets)
    monkeypatch.setattr(jhm, "grow", j_grow)


def _keys(rng, n, hi=0xFFFFFFF0):
    return rng.choice(hi, n, replace=False).astype(np.uint32)


def assert_same_stack(t, j):
    """Equal stacked leaves: ``hashmap.to_numpy`` of the port's stacked
    table against JAX's stacked pytree."""
    got, want = thm.to_numpy(t), jax_leaves(j)
    assert set(got) == set(want) == set(thm.leaf_names(t.config))
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hash_fn", HASHES)
@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_routers_match_jax(D, hash_fn):
    cfg = HashMemConfig(num_buckets=48, hash_fn=hash_fn)
    rng = np.random.default_rng(D)
    keys = np.concatenate([rng.integers(0, 2**32, 4000, dtype=np.uint64)
                           .astype(np.uint32),
                           np.array([0, 1, 0xFFFFFFF0, 0xFFFFFFFE,
                                     0xFFFFFFFF], np.uint32)])
    jk, tk = jnp.asarray(keys), torch.from_numpy(keys.view(np.int32))
    jc = jcfg(cfg)
    for shard_by in trlu.SHARD_ROUTERS:
        want_o = np.asarray(jrlu.owner_of(jk, jc, D, shard_by))
        np.testing.assert_array_equal(
            trlu.owner_of(tk, cfg, D, shard_by).numpy(), want_o)
        np.testing.assert_array_equal(
            trlu.owner_of_np(keys, cfg, D, shard_by), want_o)
        np.testing.assert_array_equal(
            jrlu.owner_of_np(keys, jc, D, shard_by), want_o)
        jo, jl = jrlu.owner_and_local_bucket(jk, jc, D, shard_by)
        to, tl = trlu.owner_and_local_bucket(keys, cfg, D, shard_by)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        grown = dataclasses.replace(cfg, num_buckets=96)
        np.testing.assert_array_equal(
            trlu._local_bucket_fn(D, shard_by)(tk, grown).numpy(),
            np.asarray(jrlu._local_bucket_fn(D, shard_by)(jk, jcfg(grown))))
        assert to.max() < D


# ---------------------------------------------------------------------------
# Sharded build and the routed host-level insert
# ---------------------------------------------------------------------------

def _small_cfg(displaced: bool) -> HashMemConfig:
    if displaced:
        return HashMemConfig(num_buckets=16, slots_per_page=32,
                             overflow_pages=32, max_chain=4, backend="ref",
                             displacement=True, fingerprint_bits=8,
                             stash_slots=16)
    return HashMemConfig(num_buckets=16, slots_per_page=64,
                         overflow_pages=64, max_chain=4, backend="perf")


@pytest.mark.parametrize("shard_by", trlu.SHARD_ROUTERS)
@pytest.mark.parametrize("displaced", [False, True], ids=["chained",
                                                          "displaced"])
def test_build_sharded_matches_jax(displaced, shard_by):
    cfg = _small_cfg(displaced)
    rng = np.random.default_rng(3)
    keys = _keys(rng, 600)
    keys[:20] = keys[20:40]                              # duplicates
    vals = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(
        np.uint32)
    t = trlu.build_sharded(cfg, keys, vals, 3, shard_by, device=CPU)
    j = j_build_sharded(jcfg(cfg), jnp.asarray(keys), jnp.asarray(vals), 3,
                        shard_by=shard_by)
    assert t.store.pool.shape == (3, cfg.num_pages, cfg.slots_per_page, 2)
    assert_same_stack(t, j)
    for d, shard in enumerate(thm.unstack(t)):          # views of the stack
        assert shard.store.pool.data_ptr() == t.store.pool[d].data_ptr()
    back = thm.from_numpy(cfg, thm.to_numpy(t), device=CPU)
    assert_same_stack(back, j)


def test_insert_sharded_grows_every_shard_as_jax(jitted_jax_loops):
    """A batch far past every shard's capacity: all shards grow together
    (rebuild mode), as ``tests/test_distributed.py`` forces on the mesh."""
    cfg = HashMemConfig(num_buckets=4, slots_per_page=32, overflow_pages=4,
                        max_chain=3, backend="perf", auto_grow=True)
    rng = np.random.default_rng(17)
    k0 = rng.choice(2**30, 64, replace=False).astype(np.uint32)
    k1 = np.setdiff1d(rng.choice(2**30, 1500, replace=False)
                      .astype(np.uint32), k0)
    t = trlu.build_sharded(cfg, k0, k0 * 2, 4, device=CPU)
    j = j_build_sharded(jcfg(cfg), jnp.asarray(k0), jnp.asarray(k0 * 2), 4)
    tev, jev = {}, {}
    t, tok, tcfg = trlu.insert_sharded(t, k1, k1 * 2, cfg, 4, events=tev)
    j, jok, jc = jrlu.insert_sharded(j, jnp.asarray(k1), jnp.asarray(k1 * 2),
                                     jcfg(cfg), 4, events=jev)
    assert tok.numpy().all() and np.asarray(jok).all()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jc)
    assert tcfg.num_buckets > cfg.num_buckets and tev == jev
    assert tev["rebuilds"] >= 1
    assert_same_stack(t, j)


def test_insert_sharded_extendible_splits_and_doubles_as_jax(
        jitted_jax_loops):
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=60,
                        max_chain=2, backend="ref", auto_grow=True,
                        resize="extendible", max_load_factor=1.0)
    rng = np.random.default_rng(9)
    keys = _keys(rng, 96)
    t = thm.stack([thm.create(cfg, device=CPU) for _ in range(2)])
    j = jax.tree.map(lambda *xs: jnp.stack(xs),
                     *[jhm.create(jcfg(cfg)) for _ in range(2)])
    tev, jev = {}, {}
    tcfg, jc = cfg, jcfg(cfg)
    for lo in range(0, keys.size, 48):
        kb = keys[lo:lo + 48]
        t, tok, tcfg = trlu.insert_sharded(t, kb, kb + 1, tcfg, 2,
                                           shard_by="highbits", events=tev)
        j, jok, jc = jrlu.insert_sharded(j, jnp.asarray(kb),
                                         jnp.asarray(kb + 1), jc, 2,
                                         shard_by="highbits", events=jev)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jc)
        assert tev == jev
        assert_same_stack(t, j)
    assert tev.get("splits", 0) > 0 and tev.get("doublings", 0) > 0, tev
    assert tev.get("rebuilds", 0) == 0, tev


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _j_routes(q, owner, D, c, pad, drop_invalid):
    """JAX's ``_Route`` of each source block."""
    ql = q.size // D
    return [jrlu._Route(jnp.asarray(q[s * ql:(s + 1) * ql]),
                        jnp.asarray(owner[s * ql:(s + 1) * ql]), D, c,
                        jnp.uint32(pad), drop_invalid=drop_invalid)
            for s in range(D)]


def _route_batch(D, ql, skew, seed, pads=0):
    rng = np.random.default_rng(seed)
    cfg = HashMemConfig(num_buckets=32)
    q = rng.integers(0, 2**31, D * ql).astype(np.uint32)
    if skew:                                   # every key owned by shard 0
        cand = np.arange(1, 200_000, dtype=np.uint32)
        cand = cand[trlu.owner_of_np(cand, cfg, D, "highbits") == 0]
        q = rng.choice(cand, D * ql).astype(np.uint32)
    if pads:
        q[rng.choice(q.size, pads, replace=False)] = trlu.ROUTE_PAD
    return cfg, q


@pytest.mark.parametrize("drop_invalid", [False, True])
@pytest.mark.parametrize("cap", ["q_local", "need", "need+3"])
@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
def test_route_matches_jax(skew, cap, drop_invalid):
    D, ql = 4, 24
    cfg, q = _route_batch(D, ql, skew, seed=5 + skew, pads=7)
    owner = trlu.owner_of_np(q, cfg, D, "highbits")
    need = trlu.routing_cap(q, cfg, D, "highbits", quantum=1) \
        if drop_invalid else int(np.bincount(
            (np.arange(q.size) // ql) * D + owner, minlength=D * D).max())
    c = {"q_local": ql, "need": need, "need+3": need + 3}[cap]
    c = min(c, ql) if cap != "need+3" else c
    pad = int(trlu.ROUTE_PAD)
    rt = trlu._Route(torch.from_numpy(q.astype(np.int64)),
                     torch.from_numpy(owner.astype(np.int64)), D, c, pad,
                     drop_invalid)
    jrts = _j_routes(q, owner, D, c, pad, drop_invalid)
    np.testing.assert_array_equal(
        rt.send.numpy(), np.stack([np.asarray(r.send) for r in jrts]))
    if drop_invalid:
        np.testing.assert_array_equal(
            rt.counts().numpy(), np.stack([np.asarray(r.counts())
                                           for r in jrts]))
    # results at the destinations, (D_dst, D_src * c), routed back
    rng = np.random.default_rng(1)
    res = rng.integers(0, 2**31, (D, D * c)).astype(np.int64)
    flag = rng.random((D, D * c)) < 0.6
    got_v = rt.gather_back(torch.from_numpy(res.reshape(-1))).numpy()
    got_f = rt.gather_back(torch.from_numpy(flag.reshape(-1))).numpy()
    want_v, want_f = [], []
    for s, r in enumerate(jrts):
        back_v = jnp.asarray(res[:, s * c:(s + 1) * c].astype(np.uint32))
        back_f = jnp.asarray(flag[:, s * c:(s + 1) * c])
        want_v.append(np.asarray(r.gather_back(back_v)))
        want_f.append(np.asarray(r.gather_back(back_f, mask_overflow=True)))
    np.testing.assert_array_equal(got_v, np.concatenate(want_v))
    np.testing.assert_array_equal(got_f, np.concatenate(want_f))


def test_unfused_route_overflow_keeps_the_last_in_capacity_entry():
    """The documented divergence (ROADMAP Queue 3): source block 0 sends
    [11, 12, 13, 14] with owners [0, 0, 0, 1] at c = 2.  JAX's unfused
    route scatters the overflowed 13 to slot c - 1 as a pad and loses 12
    (``rlu.py:303-305``); the port keeps 12 in slot 1 and drops only 13.
    Every other position agrees with JAX."""
    pad = int(jrlu.EMPTY_KEY)
    q = np.array([11, 12, 13, 14, 21, 22, 23, 24], np.uint32)
    owner = np.array([0, 0, 0, 1, 1, 1, 0, 0], np.int32)
    rt = trlu._Route(torch.from_numpy(q.astype(np.int64)),
                     torch.from_numpy(owner.astype(np.int64)), 2, 2, pad)
    jrts = _j_routes(q, owner, 2, 2, pad, False)
    want = np.stack([np.asarray(r.send) for r in jrts])
    got = rt.send.numpy()
    np.testing.assert_array_equal(want[0], [[11, pad], [14, pad]])
    np.testing.assert_array_equal(got[0], [[11, 12], [14, pad]])
    assert (got != want).sum() == 1                   # only query 12's slot
    np.testing.assert_array_equal(got[1], want[1])
    found = rt.gather_back(torch.ones(8, dtype=torch.bool)).numpy()
    jfound = np.concatenate([np.asarray(r.gather_back(
        jnp.ones((2, 2), bool), mask_overflow=True)) for r in jrts])
    np.testing.assert_array_equal(found, [1, 1, 0, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(jfound, [1, 1, 0, 1, 1, 1, 1, 1])
    vals = rt.gather_back(torch.arange(8)).numpy()
    assert vals[2] == 0                               # dropped: value 0


@pytest.mark.parametrize("case", ["random", "tiny", "one_shard", "all_pads",
                                  "mod"])
def test_routing_cap_matches_jax(case):
    D = 4
    cfg, q = _route_batch(D, 64, case == "one_shard", seed=11, pads=5)
    shard_by = "mod" if case == "mod" else "highbits"
    if case == "tiny":                       # Q_local < quantum
        q = q[:3 * D]
    if case == "all_pads":
        q = np.full(8 * D, trlu.ROUTE_PAD, np.uint32)
    for quantum in (1, 8, 16):
        want = jrlu.routing_cap(q, jcfg(cfg), D, shard_by, quantum=quantum)
        assert trlu.routing_cap(q, cfg, D, shard_by,
                                quantum=quantum) == want
    if case == "one_shard":
        assert trlu.routing_cap(q, cfg, D, shard_by) == 64
    if case == "tiny":
        assert trlu.routing_cap(q, cfg, D, shard_by) == 3


# ---------------------------------------------------------------------------
# bucket_fn entry points of hashmap
# ---------------------------------------------------------------------------

def _shard_pair(cfg, D=3, shard_by="mod"):
    """Shard 1 of a sharded build in both packages (chained or displaced),
    with a few deletes, and the router's bucket_fn of each."""
    rng = np.random.default_rng(21)
    keys = _keys(rng, 500)
    t = trlu.build_sharded(cfg, keys, keys ^ 7, D, shard_by, device=CPU)
    j = j_build_sharded(jcfg(cfg), jnp.asarray(keys), jnp.asarray(keys ^ 7),
                        D, shard_by=shard_by)
    t = thm.unstack(t)[1]
    j = jax.tree.map(lambda x: x[1], j)
    mine = keys[trlu.owner_of_np(keys, cfg, D, shard_by) == 1]
    t, _ = thm.delete_with_buckets(
        t, mine[:9], trlu._local_bucket_fn(D, shard_by)(
            torch.from_numpy(mine[:9].astype(np.int64)), cfg))
    jfn = J_BUCKET_FNS[D, shard_by]
    j, _ = j_delete_wb(j, jnp.asarray(mine[:9]),
                       jfn(jnp.asarray(mine[:9]), jcfg(cfg)))
    return t, trlu._local_bucket_fn(D, shard_by), j, jfn, mine


@pytest.mark.parametrize("entry", ["grow", "compact", "rebuild_check",
                                   "grow_displaced", "compact_displaced",
                                   "insert_auto"])
def test_bucket_fn_rebuild_entry_points_match_jax(entry, jitted_jax_loops):
    displaced = entry.endswith("displaced")
    cfg = _small_cfg(displaced)
    if entry == "insert_auto":
        cfg = dataclasses.replace(cfg, overflow_pages=8, max_chain=2,
                                  max_load_factor=0.3)
    t, tfn, j, jfn, mine = _shard_pair(cfg)
    if entry.startswith("grow"):
        t, j = thm.grow(t, bucket_fn=tfn), jhm.grow(j, bucket_fn=jfn)
    elif entry.startswith("compact"):
        t, j = thm.compact(t, bucket_fn=tfn), j_compact(j, bucket_fn=jfn)
    elif entry == "rebuild_check":
        big = dataclasses.replace(cfg, num_buckets=8, slots_per_page=1)
        assert thm.rebuild_check(t, big, bucket_fn=tfn) \
            == jhm.rebuild_check(j, jcfg(big), bucket_fn=jfn)
        one = thm.rebuild_check(t, big, bucket_fn=lambda k, c: 0 * k)
        assert one == jhm.rebuild_check(j, jcfg(big),
                                        bucket_fn=lambda k, c: 0 * k)
        assert one["max_chain_needed"] == mine.size - 9   # all in bucket 0
        return
    else:
        rng = np.random.default_rng(4)
        new = _keys(rng, 400)
        tev, jev = {}, {}
        t, tok = thm.insert_auto(t, new, new + 3, bucket_fn=tfn, events=tev)
        j, jok = jhm.insert_auto(j, jnp.asarray(new), jnp.asarray(new + 3),
                                 bucket_fn=jfn, events=jev)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert tev == jev and tev["rebuilds"] > 0
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert_same_state(t, j)
    b = tfn(torch.from_numpy(mine.astype(np.int64)), t.config)
    tv, tf = thm.probe_with_buckets(t, mine, b)
    jv, jf = j_probe_wb(j, jnp.asarray(mine),
                        jfn(jnp.asarray(mine), j.config))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tf[9:].all() and not tf[:9].any()


@pytest.mark.parametrize("entry", ["split_group", "grow_extendible",
                                   "insert_extendible"])
def test_bucket_fn_extendible_entry_points_match_jax(entry,
                                                     jitted_jax_loops):
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=60,
                        max_chain=2, backend="ref", resize="extendible",
                        max_load_factor=1.0)
    D, shard_by = 2, "mod"
    tfn, jfn = trlu._local_bucket_fn(D, shard_by), J_BUCKET_FNS[D, shard_by]
    rng = np.random.default_rng(2)
    keys = _keys(rng, 400)
    keys = keys[trlu.owner_of_np(keys, cfg, D, shard_by) == 0]
    b = tfn(torch.from_numpy(keys.astype(np.int64)), cfg).numpy()
    hot = keys[b == 1][:9]                     # nine keys of local bucket 1
    t, _ = thm.insert_with_buckets(thm.create(cfg, device=CPU), hot, hot,
                                   b[b == 1][:9])
    j, _ = jhm.insert_with_buckets(jhm.create(jcfg(cfg)), jnp.asarray(hot),
                                   jnp.asarray(hot),
                                   jnp.asarray(b[b == 1][:9]))
    if entry == "split_group":
        t, j = thm.double_directory(t), jhm.double_directory(j)
        (t, ts), (j, js) = (thm.split_group(t, 1, bucket_fn=tfn),
                            jhm.split_group(j, 1, bucket_fn=jfn))
        assert ts == js == "ok"
    elif entry == "grow_extendible":
        (t, th), (j, jh) = (thm.grow_extendible(t, 1, bucket_fn=tfn),
                            jhm.grow_extendible(j, 1, bucket_fn=jfn))
        assert th == jh
    else:
        tev, jev = {}, {}
        t, tok = thm.insert_extendible(t, keys[:60], keys[:60] + 1,
                                       bucket_fn=tfn, events=tev)
        j, jok = jhm.insert_extendible(j, jnp.asarray(keys[:60]),
                                       jnp.asarray(keys[:60] + 1),
                                       bucket_fn=jfn, events=jev)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert tev == jev and tev.get("splits", 0) > 0, tev
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert_same_state(t, j)
