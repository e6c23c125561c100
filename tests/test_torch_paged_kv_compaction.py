"""Manager cases of ``tests/test_paged_kv.py`` on the port's
``PageTableManager``: compaction on chain length and on the tick clock,
probe backends, and coalesced allocation and frees."""
import numpy as np
import pytest

from repro.data.kv_synth import churn_workload

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap
from repro_torch.core.paged_kv import PageTableManager

import torch_threads
import paged_kv_cases
from paged_kv_cases import CPU

_jitted_page_table = paged_kv_cases._jitted_page_table
_no_grad = paged_kv_cases._no_grad

one_thread = torch_threads.one_thread


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
