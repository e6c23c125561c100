"""Parity of the port's ``PageTableManager`` with the JAX package's, driven by
one call sequence on both sides, with pages, free lists, owners, grow and
compact events and the table's leaves equal bit for bit; then manager cases
of ``tests/test_paged_kv.py`` on the port. Tolerance 0."""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import HashMemConfig as JaxConfig
from repro.core import paged_kv as jkv

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap
from repro_torch.core.paged_kv import PageTableManager

from hashmap_cases import jax_leaves
import torch_threads
import paged_kv_cases
from paged_kv_cases import CPU

_jitted_page_table = paged_kv_cases._jitted_page_table
_no_grad = paged_kv_cases._no_grad

one_thread = torch_threads.one_thread


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


def test_manager_exhaustion():
    mgr = PageTableManager(8, num_channels=2, backend="ref", device=CPU)
    mgr.alloc_seq(1, 8)
    with pytest.raises(MemoryError):
        mgr.alloc_seq(2, 2)


def test_alloc_seq_zero_blocks():
    mgr = PageTableManager(32, num_channels=1, backend="ref", device=CPU)
    bt = mgr.alloc_seq(7, 0)
    assert bt.shape == (0,)
    assert mgr.live_pages() == 0
    mgr.free_seq(7)
    assert mgr.compact_events == 0
