"""Parity of the port's paged KV cache (``repro_torch.core.paged_kv``) with
the JAX package's: ``append``, ``prefill_pages`` and
``paged_decode_attention`` on the same inputs (the duplicate-write case of
idle decode slots, and writes past a sliding-window table, included); JAX's
channel-sharded sublayer at one channel (the ``(1, 1)`` mesh its serving
CLI uses) against the port's gather path; and ``PageTableManager`` driven
by one call sequence on both sides, with pages, free lists, owners, grow
and compact events and the table's leaves equal bit for bit.  The seven
manager cases of ``tests/test_paged_kv.py`` run on the port at the end.

Tolerance: pools written by ``append``/``prefill_pages`` are exact (a
scatter of the same float32 values); attention outputs rtol = atol = 5e-4,
the JAX package's own tolerance for paged decode (float32 on both sides,
summation order apart)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import HashMemConfig as JaxConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import hashmap as jhm
from repro.core import paged_kv as jkv
from repro.data.kv_synth import churn_workload
from repro.launch.mesh import make_mesh
from repro.models import model as jmodel
from repro.models import transformer as jtransformer

from repro_torch.configs import HashMemConfig, smoke_config
from repro_torch.core import hashmap
from repro_torch.core import paged_kv as tkv
from repro_torch.core.paged_kv import PageTableManager
from repro_torch.models import attention
from repro_torch.models import transformer as ttransformer

from test_torch_hashmap import jax_leaves

CPU = "cpu"
TOL = dict(rtol=5e-4, atol=5e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def _pad(a, fill, m):
    a = jnp.asarray(a)
    return jnp.concatenate([a, jnp.broadcast_to(jnp.asarray(fill, a.dtype),
                                                (m - a.shape[0],))])


def jitted_jax_page_table():
    """The JAX hashmap functions a PageTableManager calls, jitted (eager
    JAX compiles every primitive anew): batches padded to a power of two,
    inserts with ``valid=False`` pads, deletes with copies of their first
    key (a duplicate query tombstones the same slot, JAX's contract).
    Returns a MonkeyPatch context whose exit restores them."""
    j_iwb = jax.jit(jhm.insert_with_buckets)
    j_del = jax.jit(jhm.delete)

    def insert_with_buckets(hm, keys, vals, b, valid=None):
        n = keys.shape[0]
        m = max(8, 1 << (n - 1).bit_length())
        v = jnp.ones((n,), bool) if valid is None else jnp.asarray(valid)
        hm2, ok = j_iwb(hm, _pad(keys, 0, m), _pad(vals, 0, m),
                        _pad(b, 0, m), _pad(v, False, m))
        return hm2, ok[:n]

    def delete(hm, keys):
        n = keys.shape[0]
        m = max(8, 1 << (n - 1).bit_length())
        hm2, found = j_del(hm, _pad(keys, jnp.asarray(keys)[0], m))
        return hm2, found[:n]

    mp = pytest.MonkeyPatch()
    mp.setattr(jhm, "insert_with_buckets", insert_with_buckets)
    mp.setattr(jhm, "delete", delete)
    mp.setattr(jhm, "grow", jax.jit(jhm.grow, static_argnames=("factor",
                                                               "bucket_fn")))
    mp.setattr(jhm, "compact", jax.jit(jhm.compact,
                                       static_argnames=("bucket_fn",)))
    mp.setattr(jhm, "hash_to_bucket", jax.jit(
        jhm.hash_to_bucket, static_argnames=("num_buckets", "fn", "salt")))
    mp.setattr(jhm, "live_count", jax.jit(jhm.live_count))
    mp.setattr(jhm, "chain_lengths", jax.jit(jhm.chain_lengths))
    return mp


@pytest.fixture(scope="module", autouse=True)
def _jitted_page_table():
    mp = jitted_jax_page_table()
    yield
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def _no_grad():
    """The models' parameters carry gradients (the training stack); these
    tests compare values, so they build no autograd graph."""
    with torch.no_grad():
        yield


def pools(rng, P=12, pt=4, K=2, hd=8):
    k = rng.standard_normal((P, pt, K, hd)).astype(np.float32)
    v = rng.standard_normal((P, pt, K, hd)).astype(np.float32)
    return k, v


# ---------------------------------------------------------------------------
# The cache functions
# ---------------------------------------------------------------------------

APPEND_CASES = {
    # distinct tail pages
    "distinct": ([[0, 1, 2], [3, 4, 5], [6, 7, 8]], [0, 5, 11]),
    # idle rows 1 and 3 keep a stale table on pages recycled to rows 0 and
    # 2 at the same (page, offset): the last row in batch order lands
    "duplicates": ([[0, 1, 2], [0, 9, 2], [6, 7, 8], [0, 7, 10], [6, 7, 8]],
                   [1, 1, 6, 6, 6]),
    # a window-bounded table of 3 pages: positions 12+ lie past it and JAX
    # drops those writes (one of them shares row 0's page)
    "past_table": ([[0, 1, 2], [3, 4, 5], [0, 1, 2]], [13, 2, 4]),
}


@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_append_matches_jax(case):
    rng = np.random.default_rng(3)
    bt, pos = (np.asarray(a, np.int32) for a in APPEND_CASES[case])
    kp, vp = pools(rng)
    kn = rng.standard_normal((len(pos), 1, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((len(pos), 1, 2, 8)).astype(np.float32)
    jk, jv = jkv.append(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                        jnp.asarray(pos), jnp.asarray(kn), jnp.asarray(vn))
    tk, tv = t(kp), t(vp)
    ok, ov = tkv.append(tk, tv, t(bt), t(pos), t(kn), t(vn))
    assert ok is tk and ov is tv          # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case == "duplicates":   # the winners are the last rows in order
        np.testing.assert_array_equal(tk.numpy()[0, 1], kn[1, 0])
        np.testing.assert_array_equal(tk.numpy()[7, 2], kn[4, 0])
    if case == "past_table":   # nothing written for row 0
        assert (tk.numpy() != kp).any(axis=(2, 3)).sum() == 2


def test_prefill_pages_matches_jax():
    rng = np.random.default_rng(4)
    kp, vp = pools(rng)
    B, S = 3, 8
    k = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    v = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    bt = np.asarray([[5, 2, 0], [11, 3, 0], [7, 9, 0]], np.int32)
    jk, jv = jkv.prefill_pages(jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(bt), jnp.asarray(k), jnp.asarray(v))
    tk, tv = tkv.prefill_pages(t(kp), t(vp), t(bt), t(k), t(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_attention_matches_jax(window):
    rng = np.random.default_rng(5)
    cfg = smoke_config("llama3-8b").replace(sliding_window=window)
    jcfg = j_smoke_config("llama3-8b").replace(sliding_window=window)
    kp, vp = pools(rng, K=4, hd=32)
    q = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    bt = np.asarray([[0, 4, 8], [1, 5, 9], [11, 2, 6]], np.int32)
    pos = np.asarray([0, 6, 11], np.int32)
    want = jkv.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(bt),
                                      jnp.asarray(pos), jcfg)
    got = tkv.paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["distinct", "duplicates"])
def test_sharded_sublayer_at_one_channel_equals_gather(case):
    """JAX's serving CLI decodes on a (1, 1) mesh: ``ctx.sharded`` is True
    and each attention layer runs ``append_sharded`` and
    ``decode_attention_sharded`` inside ``shard_map`` at Dm = 1.  Its pools
    and output equal JAX's gather path and the port's (same geometry),
    duplicate writes of idle rows included."""
    rng = np.random.default_rng(6)
    jcfg = j_smoke_config("qwen3-8b").replace(dtype="float32")
    cfg = smoke_config("qwen3-8b").replace(dtype="float32")
    rows, pos = APPEND_CASES[case]
    B, pt = len(pos), 4
    jscfg = JServeConfig(model=jcfg, shape=JShapeConfig("t", 12, B, "decode"),
                         kv_page_tokens=pt)
    ctx_gather = jmodel.make_decode_ctx(jcfg, jscfg, B)
    ctx_sharded = jmodel.make_decode_ctx(
        jcfg, jscfg, B, mesh=make_mesh((1, 1), ("data", "model")))
    assert ctx_sharded.sharded and not ctx_gather.sharded
    for f in ("page_tokens", "n_pages", "pool_pages"):
        assert getattr(ctx_sharded, f) == getattr(ctx_gather, f)
    P = ctx_gather.pool_pages
    bt = np.asarray(rows, np.int32) % P
    pos = np.asarray(pos, np.int32)
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd),
              "wo": (H, hd, d), "q_scale": (hd,), "k_scale": (hd,)}
    p = attention.Attention(cfg, CPU)
    jp = {}
    for k, shape in shapes.items():
        a = (rng.standard_normal(shape) / np.sqrt(d)).astype(np.float32)
        getattr(p, k).data.copy_(t(a))
        jp[k] = jnp.asarray(a)
    sublayer = jax.jit(jtransformer._paged_attn_sub, static_argnums=(1, 6))
    kp, vp = pools(rng, P=P, pt=pt, K=cfg.num_kv_heads, hd=cfg.head_dim)
    h = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    out = {}
    for name, ctx in (("gather", ctx_gather), ("sharded", ctx_sharded)):
        state = {"k_pool": jnp.asarray(kp), "v_pool": jnp.asarray(vp)}
        sub, st = sublayer(jp, jcfg, jnp.asarray(h), state, jnp.asarray(bt),
                           jnp.asarray(pos), ctx)
        out[name] = [np.asarray(x) for x in (sub, st["k_pool"],
                                             st["v_pool"])]
    state = {"k_pool": t(kp), "v_pool": t(vp)}
    sub, st = ttransformer._paged_attn_sub(p, cfg, t(h), state, t(bt), t(pos),
                                           None)
    port = [sub.numpy(), st["k_pool"].numpy(), st["v_pool"].numpy()]
    for a, b in zip(out["sharded"][1:], out["gather"][1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out["sharded"][0], out["gather"][0], **TOL)
    for a, b in zip(port, out["sharded"]):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# PageTableManager against JAX's, call for call
# ---------------------------------------------------------------------------

def _state(mgr, leaves):
    return dict(free=[list(a) for a in mgr.free],
                owned={k: list(v) for k, v in mgr.owned.items()},
                grows=mgr.grow_events, compacts=mgr.compact_events,
                tombstones=mgr._tombstones, leaves=leaves)


def _same(got, want, where):
    g, w = dict(got), dict(want)
    gl, wl = g.pop("leaves"), w.pop("leaves")
    assert g == w, where
    assert set(gl) == set(wl), where
    for name in wl:
        assert gl[name].dtype == wl[name].dtype, (where, name)
        np.testing.assert_array_equal(gl[name], wl[name],
                                      err_msg=f"{where}: {name}")


MANAGER_SCENARIOS = {
    # a tiny perf table: it grows, then compacts on the tombstone fraction
    "grow_and_compact": dict(total=64, channels=2, groups=2, hm=dict(
        num_buckets=4, slots_per_page=8, overflow_pages=4, max_chain=8,
        backend="perf")),
    # chain-length compaction on hot chains, no growth
    "chain_compaction": dict(total=48, channels=1, groups=1, hm=dict(
        num_buckets=4, slots_per_page=4, overflow_pages=64, max_chain=8,
        backend="ref", auto_grow=False, compact_tombstone_frac=1.0,
        compact_chain_len=2)),
    # the manager's default table
    "default": dict(total=96, channels=3, groups=1, hm=None),
}


@pytest.mark.parametrize("name", sorted(MANAGER_SCENARIOS))
def test_manager_matches_jax_call_for_call(name):
    sc = MANAGER_SCENARIOS[name]
    tcfg = HashMemConfig(**sc["hm"]) if sc["hm"] else None
    jcfg = JaxConfig(**dataclasses.asdict(tcfg)) if tcfg else None
    kw = dict(num_channels=sc["channels"], num_groups=sc["groups"])
    jm = jkv.PageTableManager(sc["total"], hashmem_cfg=jcfg, backend="perf",
                              **kw)
    tm = PageTableManager(sc["total"], hashmem_cfg=tcfg, backend="perf",
                          device=CPU, **kw)
    rng = np.random.default_rng(11)
    next_id, ops = 0, 0
    for i in range(40):
        r = rng.random()
        live = sorted(jm.owned)
        if r < 0.5 or not live:
            reqs = [(next_id + j, int(rng.integers(0, 5)),
                     int(rng.integers(0, sc["groups"])))
                    for j in range(int(rng.integers(1, 4)))]
            next_id += len(reqs)
            try:
                want = jm.alloc_seqs(reqs)
            except MemoryError:
                with pytest.raises(MemoryError):
                    tm.alloc_seqs(reqs)
                want = got = None
            else:
                got = tm.alloc_seqs(reqs)
            if want is not None:
                assert set(got) == set(want)
                for s in want:
                    np.testing.assert_array_equal(got[s], want[s])
                    assert got[s].dtype == want[s].dtype
        elif r < 0.85:
            pick = [s for s in live if rng.random() < 0.5]
            jm.free_seqs(pick)
            tm.free_seqs(pick)
        else:
            jm.tick()
            tm.tick()
        ops += 1
        _same(_state(tm, hashmap.to_numpy(tm.hm)),
              _state(jm, jax_leaves(jm.hm)), f"op {i}")
        assert tm.cfg == HashMemConfig(**dataclasses.asdict(jm.cfg))
    live = sorted(jm.owned)
    if live:
        n = max(len(v) for v in jm.owned.values())
        np.testing.assert_array_equal(tm.block_table(live, n),
                                      jm.block_table(live, n))
    if name == "grow_and_compact":
        assert tm.grow_events >= 1 and tm.compact_events >= 1
    if name == "chain_compaction":
        assert tm.compact_events >= 1


def test_manager_rejects_reserved_keys_before_claiming_pages():
    for mgr in (jkv.PageTableManager(16), PageTableManager(16, device=CPU)):
        before = [list(a) for a in mgr.free]
        with pytest.raises(ValueError, match="reserved"):
            # the last block's key, 0xFFFFF000 + 4089, is reserved
            mgr.alloc_seqs([(0xFFFFF000 // mgr.MAX_BLOCKS, 4090, 0)])
        assert [list(a) for a in mgr.free] == before and not mgr.owned


# ---------------------------------------------------------------------------
# The seven manager cases of tests/test_paged_kv.py, on the port
# ---------------------------------------------------------------------------

def test_manager_alloc_free_invariants():
    mgr = PageTableManager(64, num_channels=4, backend="ref", device=CPU)
    bt1 = mgr.alloc_seq(1, 8)
    bt2 = mgr.alloc_seq(2, 8)
    for j, p in enumerate(bt1):
        assert p // mgr.pps == j % 4
    assert mgr.live_pages() == 16
    table = mgr.block_table([1, 2], 8)
    np.testing.assert_array_equal(table[0], bt1)
    np.testing.assert_array_equal(table[1], bt2)
    mgr.free_seq(1)
    assert mgr.live_pages() == 8
    assert hashmap.stats(mgr.hm)["tombstones"] == 8
    bt3 = mgr.alloc_seq(3, 8)
    assert set(bt3) == set(bt1)
    table = mgr.block_table([3], 8)
    np.testing.assert_array_equal(table[0], bt3)


def test_chain_len_triggered_compaction():
    def run(compact_chain_len):
        cfg = HashMemConfig(num_buckets=4, slots_per_page=32,
                            overflow_pages=64, max_chain=8, backend="ref",
                            auto_grow=False, compact_tombstone_frac=1.0,
                            compact_chain_len=compact_chain_len)
        mgr = PageTableManager(64, num_channels=1, hashmem_cfg=cfg,
                               device=CPU)
        peak = 0
        for op, ks, _ in churn_workload(240, keyspace=64, seed=23,
                                        p_insert=0.5, p_delete=0.4):
            seqs = sorted({int(k) % 24 for k in ks})
            if op == "insert":
                for s in seqs:
                    if s not in mgr.owned and mgr.live_pages() + 2 <= 64:
                        mgr.alloc_seq(s, 2)
            elif op == "delete":
                for s in seqs:
                    mgr.free_seq(s)
            peak = max(peak, hashmap.max_chain_len(mgr.hm))
        live = sorted(mgr.owned)
        if live:
            table = mgr.block_table(live, 2)
            for i, s in enumerate(live):
                np.testing.assert_array_equal(table[i], mgr.owned[s])
        return mgr, peak

    mgr_chain, peak_chain = run(compact_chain_len=2)
    mgr_ctrl, peak_ctrl = run(compact_chain_len=0)
    assert mgr_chain.compact_events >= 1
    assert mgr_ctrl.compact_events == 0
    assert peak_chain < peak_ctrl
    assert hashmap.max_chain_len(mgr_chain.hm) <= \
        hashmap.max_chain_len(mgr_ctrl.hm)


def test_manager_exhaustion():
    mgr = PageTableManager(8, num_channels=2, backend="ref", device=CPU)
    mgr.alloc_seq(1, 8)
    with pytest.raises(MemoryError):
        mgr.alloc_seq(2, 2)


@pytest.mark.parametrize("backend", ["ref", "perf"])
def test_manager_probe_backends(backend):
    mgr = PageTableManager(32, num_channels=1, backend=backend, device=CPU)
    for s in range(3):
        mgr.alloc_seq(s, 4)
    t_ = mgr.block_table([0, 1, 2], 4)
    assert t_.shape == (3, 4)
    assert len(np.unique(t_)) == 12


def test_alloc_seqs_free_seqs_coalesced_equivalence(monkeypatch):
    mgr_a = PageTableManager(64, num_channels=2, backend="ref", device=CPU)
    for s in range(3):
        mgr_a.alloc_seq(s, 4)
    mgr_b = PageTableManager(64, num_channels=2, backend="ref", device=CPU)
    calls = {"n": 0}
    orig_auto, orig_ins = hashmap.insert_auto, hashmap.insert

    def count_auto(*a, **k):
        calls["n"] += 1
        return orig_auto(*a, **k)

    def count_ins(*a, **k):
        calls["n"] += 1
        return orig_ins(*a, **k)

    monkeypatch.setattr(hashmap, "insert_auto", count_auto)
    monkeypatch.setattr(hashmap, "insert", count_ins)
    phys = mgr_b.alloc_seqs([(s, 4, 0) for s in range(3)])
    monkeypatch.undo()
    assert calls["n"] == 1
    np.testing.assert_array_equal(mgr_a.block_table([0, 1, 2], 4),
                                  mgr_b.block_table([0, 1, 2], 4))
    for s in range(3):
        np.testing.assert_array_equal(phys[s], mgr_b.owned[s])
    mgr_b.free_seqs([0, 2])
    assert sorted(mgr_b.owned) == [1]
    t_ = mgr_b.block_table([1], 4)
    np.testing.assert_array_equal(t_[0], mgr_b.owned[1])
    assert mgr_b.alloc_seqs([]) == {}


def test_manager_tick_compacts_without_frees():
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=64,
                        max_chain=8, backend="ref", auto_grow=False,
                        compact_tombstone_frac=1.0, compact_chain_len=2)
    mgr = PageTableManager(64, num_channels=1, hashmem_cfg=cfg, device=CPU)
    for r in range(3):
        for s in range(6):
            mgr.alloc_seq(100 * r + s, 2)
        mgr._frees_since_chain_check = -10_000   # throttle holds during frees
        mgr.free_seqs([100 * r + s for s in range(6)])
    assert mgr.compact_events == 0
    assert mgr._tombstones > 0
    mgr._frees_since_chain_check = mgr.CHAIN_CHECK_EVERY
    before = mgr.compact_events
    for _ in range(mgr.CHAIN_CHECK_EVERY + 1):
        mgr.tick()
    assert mgr.compact_events > before
    assert mgr._tombstones == 0


def test_alloc_seq_zero_blocks():
    mgr = PageTableManager(32, num_channels=1, backend="ref", device=CPU)
    bt = mgr.alloc_seq(7, 0)
    assert bt.shape == (0,)
    assert mgr.live_pages() == 0
    mgr.free_seq(7)
    assert mgr.compact_events == 0
