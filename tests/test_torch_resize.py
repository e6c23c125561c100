"""Parity of the port's rebuild path (``grow``, ``compact``, ``rebuild_check``,
``compact_due``, ``insert_auto``) and of the per-element ``insert_scan``
with the JAX package: same keys in, bit-equal leaves out (planes included
for bit-serial tables), equal ok masks and ``events``.  Then the directed
cases of ``tests/test_mutation_diff.py`` and a short seeded schedule over
the four backends, checked against the ``DictModel`` oracle.  Tolerance 0
throughout (integer state)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HashMemConfig as JaxConfig
from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout

from model import DictModel
from test_torch_hashmap import assert_same_state
from test_torch_paged_kv import jitted_jax_page_table
import torch_threads

one_thread = torch_threads.one_thread

CPU = "cpu"
BACKENDS = ("ref", "perf", "area", "bitserial")


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax():
    """The JAX hashmap's insert, delete, grow and compact jitted while the
    file runs (eager JAX compiles every primitive anew, call after call)."""
    mp = jitted_jax_page_table()
    yield
    mp.undo()


def jcfg(cfg: HashMemConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def small(backend: str, **kw) -> HashMemConfig:
    """The ``test_mutation_diff.py`` table: 8 buckets of 32 slots."""
    return HashMemConfig(num_buckets=8, slots_per_page=32, overflow_pages=24,
                         max_chain=4, backend=backend, auto_grow=False, **kw)


def both(cfg, keys=None, vals=None):
    """The same table in both packages: empty, or after one insert."""
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    if keys is not None:
        t, tok = thm.insert(t, keys, vals)
        j, jok = jhm.insert(j, jnp.asarray(keys), jnp.asarray(vals))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    return t, j


def churned(cfg, seed=0):
    """Both tables after an insert that overflows chains and a delete of a
    quarter of the keys (duplicate queries included)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 300, 200).astype(np.uint32)
    vals = rng.integers(1, 2**32, 200, dtype=np.uint64).astype(np.uint32)
    t, j = both(cfg, keys, vals)
    dk = keys[rng.choice(200, 50)]
    t, tf = thm.delete(t, dk)
    j, jf = jhm.delete(j, jnp.asarray(dk))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert_same_state(t, j)
    return t, j, keys


def assert_same_probes(t, j, q):
    for backend in (("perf", "ref") if t.planes is None else BACKENDS):
        tv, tf = thm.probe(t, q, backend=backend)
        jv, jf = jhm.probe(j, jnp.asarray(q), backend=backend)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf), backend)
        np.testing.assert_array_equal(tv.numpy().astype(np.uint32),
                                      np.asarray(jv), backend)


@pytest.mark.parametrize("backend", ["perf", "bitserial"])
def test_grow_and_compact_match_jax(backend):
    t, j, keys = churned(small(backend, key_bits=32 if backend == "perf"
                               else 16))
    tg, jg = thm.grow(t), jhm.grow(j)
    assert tg.config == t.config.__class__(**dataclasses.asdict(jg.config))
    assert_same_state(tg, jg)
    assert thm.stats(tg)["tombstones"] == 0
    tc, jc = thm.compact(t), jhm.compact(j)
    assert_same_state(tc, jc)
    assert thm.stats(tc)["tombstones"] == 0
    assert thm.stats(tc)["live_entries"] == thm.stats(t)["live_entries"]
    t4, j4 = thm.grow(t, factor=4), jhm.grow(j, factor=4)
    assert_same_state(t4, j4)
    assert_same_probes(t4, j4, keys)
    if backend == "bitserial":
        for hm in (tg, tc, t4):
            assert torch.equal(hm.planes, tlayout.pack_bitplanes(
                hm.key_pages, hm.config.key_bits))


def test_rebuild_check_matches_jax():
    t, j, _ = churned(small("perf"))
    for new in (t.config, dataclasses.replace(t.config, num_buckets=16),
                dataclasses.replace(t.config, num_buckets=2, overflow_pages=2,
                                    max_chain=2)):
        got = thm.rebuild_check(t, new)
        want = jhm.rebuild_check(j, jcfg(new))
        assert got == want
    assert not thm.rebuild_check(t, dataclasses.replace(
        t.config, num_buckets=2, overflow_pages=2, max_chain=2))["fits"]


@pytest.mark.parametrize("chain_len", [0, 1, 4])
def test_compact_due_matches_jax(chain_len):
    """Tombstones around the 25% share of 1024 slots, with and without the
    chain trigger (the churned table has chains of 2 pages)."""
    cfg = small("perf", compact_tombstone_frac=0.25,
                compact_chain_len=chain_len)
    t, j, _ = churned(cfg)
    for tombstones in (0, 1, 256, 257):
        for kw in (dict(), dict(fraction=False), dict(chain=False)):
            assert thm.compact_due(t, tombstones, **kw) == \
                jhm.compact_due(j, tombstones, **kw), (tombstones, kw)
    assert thm.compact_due(t, 257) and not thm.compact_due(t, 0)
    assert thm.compact_due(t, 1, fraction=False) == (chain_len == 1)


@pytest.mark.parametrize("backend", ["perf", "bitserial"])
def test_insert_scan_matches_jax(backend):
    """The per-element reference, up to arena refusals: equal ok masks and
    leaves (planes included)."""
    cfg = dataclasses.replace(small(backend), overflow_pages=6)
    rng = np.random.default_rng(4)
    t, j = both(cfg)
    for _ in range(3):
        ks = rng.integers(0, 40, 120).astype(np.uint32)
        vs = rng.integers(1, 2**32, 120, dtype=np.uint64).astype(np.uint32)
        t, tok = thm.insert_scan(t, ks, vs)
        j, jok = jhm.insert_scan(j, jnp.asarray(ks), jnp.asarray(vs))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert_same_state(t, j)
    assert not tok.numpy().all()                  # the arena ran out


INSERT_AUTO_CASES = {
    # name: (config, number of keys, max_grows)
    "reactive": (HashMemConfig(num_buckets=2, slots_per_page=32,
                               overflow_pages=2, max_chain=3, backend="ref"),
                 600, 8),
    "proactive": (HashMemConfig(num_buckets=4, slots_per_page=32,
                                overflow_pages=4, max_chain=4, backend="ref",
                                max_load_factor=0.5), 199, 8),
    "bitserial": (HashMemConfig(num_buckets=2, slots_per_page=32,
                                overflow_pages=2, max_chain=3,
                                backend="bitserial", max_load_factor=0.6),
                  300, 8),
    "budgets_run_out": (HashMemConfig(num_buckets=2, slots_per_page=32,
                                      overflow_pages=1, max_chain=2,
                                      backend="perf", max_load_factor=0.9),
                        400, 1),
    "auto_grow_off": (HashMemConfig(num_buckets=2, slots_per_page=32,
                                    overflow_pages=2, max_chain=3,
                                    backend="perf", auto_grow=False), 300, 8),
}


@pytest.mark.parametrize("case", sorted(INSERT_AUTO_CASES))
def test_insert_auto_matches_jax(case):
    """Both budgets (proactive on max_load_factor, reactive on refusals),
    the ``events`` count, and refusals left standing once a budget runs
    out or growth is off."""
    cfg, n, max_grows = INSERT_AUTO_CASES[case]
    keys = np.random.default_rng(5).choice(
        2**31, n, replace=False).astype(np.uint32)
    t, j = both(cfg)
    tev, jev = {}, {}
    t, tok = thm.insert_auto(t, keys, keys, max_grows=max_grows, events=tev)
    j, jok = jhm.insert_auto(j, jnp.asarray(keys), jnp.asarray(keys),
                             max_grows=max_grows, events=jev)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tev == jev
    assert t.config == HashMemConfig(**dataclasses.asdict(j.config))
    assert_same_state(t, j)
    ok = tok.numpy()
    if case in ("budgets_run_out", "auto_grow_off"):
        assert not ok.all()
    else:
        assert ok.all() and tev["rebuilds"] >= 1
    assert_same_probes(t, j, keys)


# ---------------------------------------------------------------------------
# The directed cases of tests/test_mutation_diff.py, through both packages
# ---------------------------------------------------------------------------

def test_insert_matches_scan_reference():
    """The vectorized insert is element-for-element the sequential
    reference on collision-heavy batches, in the port as in JAX."""
    cfg = small("bitserial")
    rng = np.random.default_rng(3)
    tv, jv = both(cfg)
    ts = thm.create(cfg, device=CPU)
    for _ in range(6):
        ks = rng.integers(0, 64, 32).astype(np.uint32)   # heavy duplication
        vs = rng.integers(1, 2**31, 32).astype(np.uint32)
        tv, ok_v = thm.insert(tv, ks, vs)
        ts, ok_s = thm.insert_scan(ts, ks, vs)
        jv, jok = jhm.insert(jv, jnp.asarray(ks), jnp.asarray(vs))
        assert torch.equal(ok_v, ok_s)
        np.testing.assert_array_equal(ok_v.numpy(), np.asarray(jok))
        a, b = thm.to_numpy(tv), thm.to_numpy(ts)
        for name in thm.leaf_names(cfg):
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        assert_same_state(tv, jv)


def test_duplicate_keys_fifo_order_across_grow():
    """Duplicates: probe returns the oldest, delete pops the oldest, and the
    order survives grow and compact."""
    t, j = both(small("perf"), np.array([42, 42, 42], np.uint32),
                np.array([1, 2, 3], np.uint32))
    t, j = thm.compact(thm.grow(t)), jhm.compact(jhm.grow(j))
    assert_same_state(t, j)
    for expect in (1, 2, 3):
        v, f = thm.probe(t, np.array([42], np.uint32))
        assert bool(f[0]) and int(v[0]) == expect
        t, fd = thm.delete(t, np.array([42], np.uint32))
        j, _ = jhm.delete(j, jnp.asarray([42], jnp.uint32))
        assert bool(fd[0])
    _, f = thm.probe(t, np.array([42], np.uint32))
    assert not bool(f[0])
    assert_same_state(t, j)


def test_tombstone_then_reinsert_then_compact():
    keys = np.arange(100, 140, dtype=np.uint32)
    t, j = both(small("bitserial"), keys, keys * 2)
    t, _ = thm.delete(t, keys)
    j, _ = jhm.delete(j, jnp.asarray(keys))
    assert thm.stats(t)["tombstones"] == 40
    t, ok = thm.insert(t, keys, keys * 5)     # appended past the tombstones
    j, _ = jhm.insert(j, jnp.asarray(keys), jnp.asarray(keys * 5))
    assert bool(ok.all())
    assert thm.stats(t)["tombstones"] == 40       # not reused (paper §2.5)
    t, j = thm.compact(t), jhm.compact(j)
    assert_same_state(t, j)
    st = thm.stats(t)
    assert st["tombstones"] == 0 and st["live_entries"] == 40
    v, f = thm.probe(t, keys)
    assert bool(f.all()) and np.array_equal(v.numpy(), keys * 5)


def test_arena_exhaustion_triggers_grow():
    """insert_auto: the refusal path becomes a resize, no dropped writes."""
    cfg = HashMemConfig(num_buckets=2, slots_per_page=32, overflow_pages=2,
                        max_chain=3, backend="ref")   # capacity 128 slots
    keys = np.random.default_rng(5).choice(
        2**31, 600, replace=False).astype(np.uint32)
    hm = thm.create(cfg, device=CPU)
    _, ok_plain = thm.insert(hm, keys, keys)
    assert not bool(ok_plain.all())
    hm, ok = thm.insert_auto(hm, keys, keys)
    assert bool(ok.all()) and hm.config.num_buckets > cfg.num_buckets
    v, f = thm.probe(hm, keys)
    assert bool(f.all()) and np.array_equal(v.numpy(), keys)
    st = thm.stats(hm)
    assert st["live_entries"] == 600 and st["max_chain"] <= hm.config.max_chain


def test_max_load_factor_proactive_grow():
    cfg = HashMemConfig(num_buckets=4, slots_per_page=32, overflow_pages=4,
                        max_chain=4, backend="ref", max_load_factor=0.5)
    keys = np.arange(1, 200, dtype=np.uint32)          # 199 > 0.5 * 256
    hm, ok = thm.insert_auto(thm.create(cfg, device=CPU), keys, keys)
    assert bool(ok.all()) and hm.config.num_buckets > 4
    assert thm.stats(hm)["load_factor"] <= 0.5


@pytest.mark.parametrize("backend", BACKENDS)
def test_grow_preserves_probe_on_all_backends(backend):
    keys = np.random.default_rng(13).choice(
        2**31, 400, replace=False).astype(np.uint32)
    cfg = small(backend)
    t, tok = thm.insert_auto(thm.create(cfg, device=CPU), keys, keys + 7)
    j, jok = jhm.insert_auto(jhm.create(jcfg(cfg)), jnp.asarray(keys),
                             jnp.asarray(keys + 7))
    assert bool(tok.all())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert_same_state(t, j)
    v, f = thm.probe(t, keys)
    assert bool(f.all()) and np.array_equal(v.numpy(), keys + 7)


# ---------------------------------------------------------------------------
# A short seeded schedule over the four backends (run_schedule's shape)
# ---------------------------------------------------------------------------

OPS = np.array(["insert", "probe", "delete", "grow", "compact"])
WEIGHTS = np.array([0.40, 0.25, 0.20, 0.08, 0.07])


@pytest.mark.parametrize("seed", range(4))
def test_schedule_matches_dict_model(seed):
    """Mixed insert/probe/delete/grow/compact on a plain and a bit-serial
    table: every probe through all four backends agrees with the DictModel,
    stats() invariants hold after each rebuild, planes decode to the key
    lane, and the final leaves equal JAX's after the same schedule."""
    rng = np.random.default_rng(seed)
    plain, bits = list(both(small("perf"))), list(both(small("bitserial")))
    model = DictModel()
    keyspace = rng.choice(100_000, 256, replace=False).astype(np.uint32)

    def pick(n, extra):
        live = np.asarray(model.keys(), np.uint32)
        pool = np.concatenate([live, rng.choice(keyspace, extra)
                               .astype(np.uint32)]) if live.size else keyspace
        return rng.choice(pool, n).astype(np.uint32)

    def invariants(tables, no_tombs):
        for t, _ in tables:
            st = thm.stats(t)
            assert st["live_entries"] == model.live_entries()
            assert not no_tombs or st["tombstones"] == 0
            assert (st["chain_lengths"] >= 1).all()
            assert st["max_chain"] <= t.config.max_chain
            assert int(st["chain_lengths"].sum()) == int(t.free_top)
        t = tables[1][0]
        assert torch.equal(tlayout.unpack_bitplanes(t.planes, 32),
                           t.key_pages)

    for op in list(rng.choice(OPS, 12, p=WEIGHTS)) + ["probe"]:
        if op == "insert":
            ks = rng.choice(keyspace, 8).astype(np.uint32)
            vs = rng.integers(1, 2**31, 8).astype(np.uint32)
            oks = []
            for pair in (plain, bits):
                t, ok = thm.insert(pair[0], ks, vs)
                j, _ = jhm.insert(pair[1], jnp.asarray(ks), jnp.asarray(vs))
                pair[:] = t, j
                oks.append(ok.numpy())
            assert (oks[0] == oks[1]).all()
            model.insert(ks, vs, oks[0])
        elif op == "delete":
            ks = pick(4, 4)
            exp = None
            for pair in (plain, bits):
                t, f = thm.delete(pair[0], ks)
                j, _ = jhm.delete(pair[1], jnp.asarray(ks))
                pair[:] = t, j
                exp = model.delete(ks) if exp is None else exp
                assert (f.numpy() == exp).all()
        elif op == "probe":
            ks = pick(16, 8)
            ev, ef = model.probe(ks)
            ev, ef = np.asarray(ev, np.uint32), np.asarray(ef)
            for t, backend in [(plain[0], b) for b in BACKENDS[:3]] + \
                    [(bits[0], b) for b in BACKENDS]:
                v, f = thm.probe(t, ks, backend=backend)
                assert (f.numpy() == ef).all(), backend
                assert (v.numpy()[ef] == ev[ef]).all(), backend
        else:
            if op == "grow" and plain[0].config.num_buckets >= 64:
                continue
            fn = {"grow": (thm.grow, jhm.grow),
                  "compact": (thm.compact, jhm.compact)}[op]
            for pair in (plain, bits):
                pair[:] = fn[0](pair[0]), fn[1](pair[1])
            invariants((plain, bits), no_tombs=True)
    invariants((plain, bits), no_tombs=False)
    for t, j in (plain, bits):
        assert_same_state(t, j)
