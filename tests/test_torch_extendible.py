"""Parity of the port's extendible resize with the JAX package: the cases of
``tests/test_extendible.py`` through both packages.  ``double_directory``
as a pointer copy and its refusal, ``split_group``'s four statuses and its
locality, splits instead of rebuilds, FIFO order across splits, a rebuild
resetting the directory, the churn differential on four backends, and the
``insert_auto`` budgets.  After every step both tables must hold equal
leaves (``local_depth`` included), equal configs, ``stats`` and ``events``,
and equal ok/found/probe results; tolerance 0 (integer state).

The JAX side runs its host-level loops as they are, with two of its module
functions swapped for jitted forms so that the file stays cheap:
``insert_with_buckets`` pads each batch to a power of two with
``valid=False`` (pads write nothing and claim nothing, per its contract)
and ``grow`` is compiled once per config."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashmap as jhm
from repro.core.hashing import hash_to_bucket as j_hash

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core.hashing import bits_used

from model import DictModel, mine_bucket_colliding_keys
from test_torch_hashmap import assert_same_state, jcfg

CPU = "cpu"

j_iwb = jax.jit(jhm.insert_with_buckets)
j_grow = jax.jit(jhm.grow, static_argnames=("factor", "bucket_fn"))
j_delete = jax.jit(jhm.delete)
j_probe = jax.jit(lambda hm, q: jhm.probe(hm, q, backend="ref"))


def padded_insert_with_buckets(hm, keys, vals, b, valid=None):
    n = keys.shape[0]
    m = max(8, 1 << (n - 1).bit_length())

    def pad(a, fill):
        a = jnp.asarray(a)
        return jnp.concatenate([a, jnp.full((m - n,), fill, a.dtype)])

    v = jnp.ones((n,), bool) if valid is None else jnp.asarray(valid)
    hm2, ok = j_iwb(hm, pad(keys, 0), pad(vals, 0), pad(b, 0), pad(v, False))
    return hm2, ok[:n]


@pytest.fixture(autouse=True)
def jitted_jax_loops(monkeypatch):
    monkeypatch.setattr(jhm, "insert_with_buckets", padded_insert_with_buckets)
    monkeypatch.setattr(jhm, "grow", j_grow)


def ecfg(**kw) -> HashMemConfig:
    """``tests/test_extendible.py``'s ``_cfg``."""
    base = dict(num_buckets=8, slots_per_page=4, overflow_pages=120,
                max_chain=4, backend="ref", auto_grow=True,
                resize="extendible", max_load_factor=1.0)
    base.update(kw)
    return HashMemConfig(**base)


def assert_same(t, j):
    """Equal configs, leaves and stats."""
    assert t.config == HashMemConfig(**dataclasses.asdict(j.config))
    assert_same_state(t, j)
    ts, js = thm.stats(t), jhm.stats(j)
    assert ts.keys() == js.keys()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def both(cfg):
    return thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))


def both_insert(t, j, keys, vals, how="insert"):
    """One insert entry point through both packages: equal oks."""
    if how == "insert":
        t, tok = thm.insert(t, keys, vals)
        j, jok = jhm.insert(j, jnp.asarray(keys), jnp.asarray(vals))
        tev = jev = None
    else:
        tev, jev = {}, {}
        t, tok = getattr(thm, how)(t, keys, vals, events=tev)
        j, jok = getattr(jhm, how)(j, jnp.asarray(keys), jnp.asarray(vals),
                                   events=jev)
        assert tev == jev
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    return t, j, tok.numpy(), tev


def probe_both(t, j, q):
    tv, tf = thm.probe(t, q)
    jv, jf = j_probe(j, jnp.asarray(q))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().astype(np.uint32), np.asarray(jv))
    return tv.numpy().astype(np.uint32), tf.numpy()


def bucket_of(keys, cfg):
    return int(np.asarray(j_hash(jnp.asarray(keys), cfg.num_buckets,
                                 cfg.hash_fn, cfg.salt))[0])


# ---------------------------------------------------------------------------
# Directory doubling
# ---------------------------------------------------------------------------

def test_double_directory_is_pointer_copy():
    cfg = ecfg()
    keys = np.arange(1, 33, dtype=np.uint32)
    t, j = both(cfg)
    t, j, ok, _ = both_insert(t, j, keys, keys * 3)
    assert ok.all()
    t2, j2 = thm.double_directory(t), jhm.double_directory(j)
    assert_same(t2, j2)
    assert t2.config.num_buckets == 2 * cfg.num_buckets
    assert t2.config.num_pages == cfg.num_pages
    assert t2.store is t.store                     # no data moves
    st = thm.stats(t2)
    assert st["global_depth"] == bits_used(cfg.num_buckets) + 1
    assert st["max_local_depth"] == bits_used(cfg.num_buckets)
    v, f = probe_both(t2, j2, keys)
    assert f.all() and (v == keys * 3).all()
    small = ecfg(num_buckets=16, overflow_pages=8)
    assert thm.double_directory(thm.create(small, device=CPU)) is None
    assert jhm.double_directory(jhm.create(jcfg(small))) is None


def test_extendible_table_crosses_over_from_jax():
    """An extendible JAX table whose groups have split crosses over leaf by
    leaf (``local_depth`` included) and goes on splitting as JAX's does."""
    cfg = ecfg(max_chain=2)
    keys = mine_bucket_colliding_keys(30, cfg.num_buckets, same_b2=False)
    vals = np.arange(1, 31, dtype=np.uint32)
    j, _ = jhm.insert_extendible(jhm.create(jcfg(cfg)), jnp.asarray(keys[:16]),
                                 jnp.asarray(vals[:16]))
    from test_torch_hashmap import jax_leaves
    cfg2 = HashMemConfig(**dataclasses.asdict(j.config))
    t = thm.from_numpy(cfg2, jax_leaves(j), device=CPU)
    assert_same(t, j)
    assert thm.stats(t)["max_local_depth"] > bits_used(cfg.num_buckets)
    t, j, ok, _ = both_insert(t, j, keys[16:], vals[16:], "insert_extendible")
    assert ok.all()
    assert_same(t, j)
    v, f = probe_both(t, j, keys)
    assert f.all() and (v == vals).all()


# ---------------------------------------------------------------------------
# split_group: statuses and locality
# ---------------------------------------------------------------------------

def test_split_group_statuses_and_locality():
    cfg = ecfg(max_chain=2, overflow_pages=56)
    t, j = both(cfg)
    t1, status = thm.split_group(t, 0)
    assert status == jhm.split_group(j, 0)[1] == "need_double" and t1 is t

    keys = mine_bucket_colliding_keys(8, cfg.num_buckets, same_b2=False)
    vals = np.arange(1, 9, dtype=np.uint32) * 7
    t, j, ok, _ = both_insert(t, j, keys, vals)
    assert ok.all()
    b0 = bucket_of(keys, cfg)
    t, j = thm.double_directory(t), jhm.double_directory(j)
    heads_before = t.bucket_head.numpy().copy()
    pool_before = thm.to_numpy(t)["pool"].copy()
    ld = bits_used(cfg.num_buckets)
    c = b0 & ((1 << ld) - 1)
    old_pages, p = [], int(heads_before[c])
    pn = t.page_next.numpy()
    while p >= 0:
        old_pages.append(p)
        p = int(pn[p])
    top_before = int(t.free_top)

    t2, status = thm.split_group(t, b0)
    j2, jstatus = jhm.split_group(j, b0)
    assert status == jstatus == "ok"
    assert_same(t2, j2)
    # only the split group's directory aliases were repointed
    gd = bits_used(t2.config.num_buckets)
    aliases = c + (np.arange(1 << (gd - ld)) << ld)
    untouched = np.setdiff1d(np.arange(t2.config.num_buckets), aliases)
    np.testing.assert_array_equal(t2.bucket_head.numpy()[untouched],
                                  heads_before[untouched])
    ch = t2.bucket_head.numpy()[aliases]
    np.testing.assert_array_equal(t2.store.local_depth.numpy()[ch], ld + 1)
    # every other group's pages are bit-identical: the split is local
    touched = set(old_pages) | set(range(top_before, int(t2.free_top)))
    other = np.setdiff1d(np.arange(cfg.num_pages), sorted(touched))
    np.testing.assert_array_equal(thm.to_numpy(t2)["pool"][other],
                                  pool_before[other])
    v, f = probe_both(t2, j2, keys)
    assert f.all() and (v == vals).all()


def test_split_group_stuck_full_and_rebuild_fallback():
    cfg = ecfg(max_chain=2, overflow_pages=56)
    keys = mine_bucket_colliding_keys(8, 64, same_b2=False)
    t, j = both(cfg)
    t, j, ok, _ = both_insert(t, j, keys, np.arange(1, 9, dtype=np.uint32))
    assert ok.all()
    b0 = bucket_of(keys, cfg)
    t, j = thm.double_directory(t), jhm.double_directory(j)

    tight_t = thm.HashMem(store=t.store, bucket_head=t.bucket_head,
                          config=dataclasses.replace(t.config, max_chain=1))
    tight_j = jhm.HashMem(store=j.store, bucket_head=j.bucket_head,
                          config=dataclasses.replace(j.config, max_chain=1))
    assert thm.split_group(tight_t, b0)[1] == "stuck"
    assert jhm.split_group(tight_j, b0)[1] == "stuck"

    full_t = thm.HashMem(store=dataclasses.replace(
        t.store, free_top=t.free_top.new_tensor(cfg.num_pages)),
        bucket_head=t.bucket_head, config=t.config)
    full_j = jhm.HashMem(store=dataclasses.replace(
        j.store, free_top=jnp.asarray(cfg.num_pages, jnp.int32)),
        bucket_head=j.bucket_head, config=j.config)
    assert thm.split_group(full_t, b0)[1] == "full"
    assert jhm.split_group(full_j, b0)[1] == "full"

    t2, how = thm.grow_extendible(full_t, b0)
    j2, jhow = jhm.grow_extendible(full_j, b0)
    assert how == jhow == "rebuild"
    assert_same(t2, j2)
    assert t2.config.num_pages > cfg.num_pages
    assert probe_both(t2, j2, keys)[1].all()


# ---------------------------------------------------------------------------
# insert_extendible: splits instead of rebuilds; FIFO order survives
# ---------------------------------------------------------------------------

def test_insert_extendible_splits_not_rebuilds():
    cfg = ecfg(max_chain=2)
    keys = mine_bucket_colliding_keys(24, cfg.num_buckets, same_b2=False)
    vals = np.arange(1, 25, dtype=np.uint32)
    t, j = both(cfg)
    t, j, ok, events = both_insert(t, j, keys, vals, "insert_extendible")
    assert ok.all()
    assert events.get("splits", 0) >= 1 and events.get("rebuilds", 0) == 0
    assert_same(t, j)
    assert t.config.num_pages == cfg.num_pages
    v, f = probe_both(t, j, keys)
    assert f.all() and (v == vals).all()
    assert thm.stats(t)["max_local_depth"] > bits_used(cfg.num_buckets)


def test_duplicate_fifo_order_survives_splits():
    cfg = ecfg(max_chain=2)
    keys = mine_bucket_colliding_keys(20, cfg.num_buckets, same_b2=False)
    dup = keys[:1]
    t, j = both(cfg)
    t, j, _, _ = both_insert(t, j, dup, np.array([111], np.uint32))
    t, j, ok, _ = both_insert(t, j, keys[1:], np.arange(1, 20, dtype=np.uint32),
                              "insert_extendible")
    t, j, ok2, _ = both_insert(t, j, dup, np.array([222], np.uint32),
                               "insert_extendible")
    assert ok.all() and ok2.all()
    assert_same(t, j)
    v, f = probe_both(t, j, dup)
    assert f[0] and v[0] == 111                       # the oldest wins
    t, tf = thm.delete(t, dup)
    j, jf = j_delete(j, jnp.asarray(dup))
    assert bool(tf[0]) and bool(jf[0])
    assert_same(t, j)
    v, f = probe_both(t, j, dup)
    assert f[0] and v[0] == 222                       # its FIFO successor


def test_rebuild_under_extendible_resets_directory_and_reclaims():
    cfg = ecfg(max_chain=2)
    keys = mine_bucket_colliding_keys(24, cfg.num_buckets, same_b2=False)
    t, j = both(cfg)
    t, j, ok, _ = both_insert(t, j, keys, np.arange(1, 25, dtype=np.uint32),
                              "insert_extendible")
    assert ok.all()
    t2, j2 = thm.compact(t), jhm.compact(j)
    assert_same(t2, j2)
    st = thm.stats(t2)
    assert st["min_local_depth"] == st["max_local_depth"] \
        == st["global_depth"]
    needed = int(np.maximum(st["chain_lengths"] - 1, 0).sum())
    assert st["free_pages"] == \
        t2.config.num_pages - t2.config.num_buckets - needed
    assert probe_both(t2, j2, keys)[1].all()


# ---------------------------------------------------------------------------
# The churn differential, four backends
# ---------------------------------------------------------------------------

def churn_schedule(cfg):
    colliders = mine_bucket_colliding_keys(48, cfg.num_buckets,
                                           same_b2=False)
    rng = np.random.default_rng(17)
    for step in range(8):
        ins = np.concatenate([
            rng.integers(1, 4000, size=12, dtype=np.uint32),
            colliders[6 * step:6 * (step + 1)]])
        vals = rng.integers(1, 2**20, size=ins.size, dtype=np.uint32)
        dels = rng.integers(1, 4000, size=4, dtype=np.uint32)
        qs = np.concatenate([ins[:8], dels,
                             rng.integers(1, 4000, size=6, dtype=np.uint32)])
        yield ins, vals, dels, qs


def churn_cfg(backend):
    S, mc = (32, 1) if backend == "bitserial" else (4, 3)
    return ecfg(backend=backend, slots_per_page=S, overflow_pages=248,
                max_chain=mc)


@functools.cache
def jax_churn(backend):
    """JAX's run of the churn: (leaves, ok, found, values, found) per step
    and the events.  The ref, perf and area tables hold the same state, so
    the ref run serves all three."""
    from test_torch_hashmap import jax_leaves
    cfg = jcfg(churn_cfg(backend))
    j = jhm.create(cfg)
    steps, events = [], {}
    for ins, vals, dels, qs in churn_schedule(cfg):
        j, ok = jhm.insert_auto(j, jnp.asarray(ins), jnp.asarray(vals),
                                events=events)
        j, found = j_delete(j, jnp.asarray(dels))
        v, f = j_probe(j, jnp.asarray(qs))
        steps.append((jax_leaves(j), j.config, *map(np.asarray,
                                                    (ok, found, v, f))))
    return steps, events


@pytest.mark.parametrize("backend", ["ref", "perf", "area", "bitserial"])
def test_extendible_churn_differential(backend):
    """Uniform churn plus 6 one-group keys a step: the hot group splits
    mid-churn.  Equal leaves, oks, founds, probes and events after every
    step, and the DictModel agrees."""
    cfg = churn_cfg(backend)
    jsteps, jevents = jax_churn("bitserial" if backend == "bitserial"
                                else "ref")
    t = thm.create(cfg, device=CPU)
    model = DictModel()
    events = {}
    for (ins, vals, dels, qs), (leaves, jc, jok, jfound, jv, jf) in zip(
            churn_schedule(cfg), jsteps):
        t, ok = thm.insert_auto(t, ins, vals, events=events)
        model.insert(ins, vals, ok.numpy())
        t, found = thm.delete(t, dels)
        np.testing.assert_array_equal(found.numpy(), model.delete(dels))
        v, f = thm.probe(t, qs)
        ev, ef = model.probe(qs)
        np.testing.assert_array_equal(f.numpy(), ef)
        np.testing.assert_array_equal(v.numpy()[ef], np.asarray(ev)[ef])
        assert dataclasses.replace(t.config, backend="x") == dataclasses \
            .replace(HashMemConfig(**dataclasses.asdict(jc)), backend="x")
        got = thm.to_numpy(t)
        assert got.keys() == leaves.keys()
        for name in got:
            np.testing.assert_array_equal(got[name], leaves[name], name)
        for a, b in [(ok, jok), (found, jfound), (f, jf)]:
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(v.numpy().astype(np.uint32), jv)
    assert events == jevents
    assert events.get("splits", 0) >= 1 and events.get("rebuilds", 0) == 0


# ---------------------------------------------------------------------------
# insert_auto: separate proactive and reactive grow budgets
# ---------------------------------------------------------------------------

def test_insert_auto_separate_proactive_reactive_budgets():
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=4,
                        max_chain=1, backend="ref", auto_grow=True,
                        hash_fn="identity", max_load_factor=0.5)
    pre = np.arange(14, dtype=np.uint32)
    t, j = both(cfg)
    t, j, ok, _ = both_insert(t, j, pre, pre + 100, "insert_auto")
    assert ok.all() and t.config.num_buckets == 4
    batch = np.asarray([15, 31, 47, 63, 79], np.uint32)
    tev, jev = {}, {}
    t, tok = thm.insert_auto(t, batch, batch * 2, max_grows=2, events=tev)
    j, jok = jhm.insert_auto(j, jnp.asarray(batch), jnp.asarray(batch * 2),
                             max_grows=2, events=jev)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().all() and tev == jev == {"rebuilds": 3}
    assert_same(t, j)
    assert t.config.num_buckets == 32
    v, f = probe_both(t, j, np.concatenate([pre, batch]))
    assert f.all()


def test_insert_auto_reactive_budget_still_bounds():
    cfg = HashMemConfig(num_buckets=4, slots_per_page=2, overflow_pages=4,
                        max_chain=1, backend="ref", auto_grow=True,
                        hash_fn="identity", max_load_factor=1.0)
    batch = np.asarray([3, 7, 11], np.uint32)
    t, j = both(cfg)
    t, tok = thm.insert_auto(t, batch, batch, max_grows=0)
    j, jok = jhm.insert_auto(j, jnp.asarray(batch), jnp.asarray(batch),
                             max_grows=0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().sum() == 2 and t.config.num_buckets == 4
    assert_same(t, j)
