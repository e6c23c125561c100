"""Parity of the port's plain probe with the JAX package's
``probe_pages_ref`` and its Pallas ``probe_pages_perf`` in interpret mode,
and with a numpy loop over the lane contract.  All state is integer, so
every comparison is exact (tolerance 0).  The CUDA kernel is held against the
plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jlayout
from repro.kernels import ref as jref
from repro.kernels.probe_perf import probe_pages_perf as jax_perf

from repro_torch.core import layout as tlayout
from repro_torch.core import probe as tprobe
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels.probe_perf import probe_pages_perf

from test_kernels_probe import make_pool, make_queries
import torch_threads

one_thread = torch_threads.one_thread

SHAPES = [(16, 128, 32, 1), (32, 256, 64, 4), (8, 512, 16, 2),
          (64, 128, 128, 3)]


def lanes_oracle(kp, vp, queries, pages):
    """numpy loop over the contract: first chain step, then lowest slot."""
    P = kp.shape[0]
    out = np.zeros((len(queries), 4), np.uint32)
    for i, q in enumerate(queries):
        for p in pages[i]:
            if p < 0:
                continue
            hit = np.flatnonzero(kp[min(p, P - 1)] == q)
            if hit.size:
                out[i] = (vp[min(p, P - 1), hit[0]], 1, p, hit[0])
                break
    return out


def t_pool(kp, vp):
    return tlayout.interleave(torch.from_numpy(kp.view(np.int32)),
                              torch.from_numpy(vp.view(np.int32)))


def t_q(q):
    return torch.from_numpy(np.ascontiguousarray(q).view(np.int32))


def t_pages(pages):
    return torch.from_numpy(np.ascontiguousarray(pages, np.int32))


def check_all(kp, vp, q, pages, interpret=True):
    """Port plain probe == numpy oracle lanes == JAX ref (== JAX perf)."""
    got = tref.probe_pages_ref(t_pool(kp, vp), t_q(q), t_pages(pages))
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, lanes_oracle(kp, vp, q, pages))
    pool = jlayout.interleave(jnp.asarray(kp), jnp.asarray(vp))
    jq, jp = jnp.asarray(q), jnp.asarray(pages)
    impls = [jref.probe_pages_ref]
    if interpret:
        impls.append(lambda *a: jax_perf(*a, interpret=True))
    for fn in impls:
        v, f = fn(pool, jq, jp)
        np.testing.assert_array_equal(got[:, 1] != 0, np.asarray(f))
        np.testing.assert_array_equal(got[:, 0], np.asarray(v))
    return got


@pytest.mark.parametrize("P,S,Q,C", SHAPES)
def test_plain_probe_matches_jax(P, S, Q, C):
    rng = np.random.default_rng(P * 1000 + S + Q + C)
    kp, vp, live = make_pool(rng, P, S)
    q, pages = make_queries(rng, kp, vp, live, Q, C, P)
    got = check_all(kp, vp, q, pages)
    assert got[:, 1].sum() >= Q // 2


def test_first_match_chain_order():
    """Duplicate key on two pages in the chain: first page wins."""
    kp = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    vp = np.zeros((4, 128), np.uint32)
    kp[1, 5] = 42; vp[1, 5] = 111
    kp[3, 77] = 42; vp[3, 77] = 222
    kp[3, 9] = 42; vp[3, 9] = 333          # lower slot on the later page
    q = np.array([42, 42], np.uint32)
    pages = np.array([[1, 3], [3, 1]], np.int32)
    got = check_all(kp, vp, q, pages)
    assert got[0].tolist() == [111, 1, 1, 5]
    assert got[1].tolist() == [333, 1, 3, 9]


def test_lowest_slot_wins_within_row():
    kp = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    vp = np.arange(512, dtype=np.uint32).reshape(4, 128)
    kp[0, [100, 31, 64, 33]] = 7
    kp[2, [3, 90]] = 8
    got = check_all(kp, vp, np.array([7, 8], np.uint32),
                    np.array([[-1, 0], [2, 0]], np.int32))
    assert got.tolist() == [[31, 1, 0, 31], [259, 1, 2, 3]]


@pytest.mark.parametrize("P,S,Q,C", [(32, 256, 64, 4), (64, 128, 128, 3)])
def test_interior_holes(P, S, Q, C):
    """-1 steps anywhere in the schedule, not just as tail padding."""
    rng = np.random.default_rng(7 + C)
    kp, vp, live = make_pool(rng, P, S)
    q, pages = make_queries(rng, kp, vp, live, Q, C, P)
    holes = rng.random(pages.shape) < 0.3
    for i in range(Q // 2):                # keep each hit's own page
        hp = np.flatnonzero(kp[np.maximum(pages[i], 0)] == q[i])
        holes[i, hp // S] = False
    pages[holes] = -1
    pages[::5, 0] = -1                     # leading holes
    got = check_all(kp, vp, q, pages)
    assert got[:, 1].sum() >= Q // 4


def test_sentinel_queries_match_as_in_jax():
    """No extra filter: a query equal to EMPTY_KEY matches an empty slot and
    one equal to TOMBSTONE_KEY a tombstone, exactly as in the JAX package."""
    kp = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    vp = np.arange(512, dtype=np.uint32).reshape(4, 128)
    kp[1, :40] = np.arange(40) + 1000
    kp[3, 6] = 0xFFFFFFFE
    q = np.array([0xFFFFFFFF, 0xFFFFFFFE], np.uint32)
    pages = np.array([[-1, 1], [1, 3]], np.int32)
    got = check_all(kp, vp, q, pages)
    assert got.tolist() == [[168, 1, 1, 40], [390, 1, 3, 6]]


def test_page_past_pool_reads_last_row_as_jax():
    kp = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    vp = np.zeros((4, 128), np.uint32)
    kp[3, 17] = 5; vp[3, 17] = 99
    got = check_all(kp, vp, np.array([5], np.uint32),
                    np.array([[0, 9]], np.int32), interpret=False)
    assert got[0].tolist() == [99, 1, 9, 17]


def test_plain_probe_chunks_agree(monkeypatch):
    rng = np.random.default_rng(11)
    kp, vp, live = make_pool(rng, 32, 256)
    q, pages = make_queries(rng, kp, vp, live, 97, 4, 32)
    whole = tref.probe_pages_ref(t_pool(kp, vp), t_q(q), t_pages(pages))
    monkeypatch.setattr(tref, "GATHER_BYTES", 5 * 4 * 256 * 8)   # 5 queries
    chunked = tref.probe_pages_ref(t_pool(kp, vp), t_q(q), t_pages(pages))
    assert torch.equal(whole, chunked)


def test_cpu_dispatch_takes_plain_version():
    rng = np.random.default_rng(5)
    kp, vp, live = make_pool(rng, 16, 128)
    q, pages = make_queries(rng, kp, vp, live, 32, 2, 16)
    args = t_pool(kp, vp), t_q(q), t_pages(pages)
    store = tlayout.empty_store(16, 128, device="cpu")
    store.pool = args[0]
    before = probe_pages_perf.launches
    want = tref.probe_pages_ref(*args)
    for backend in ("perf", "ref"):
        assert torch.equal(tprobe.probe_lanes(store, *args[1:], backend),
                           want)
    assert torch.equal(ops.probe_perf(*args), want)
    assert probe_pages_perf.launches == before     # no kernel on the CPU
    with pytest.raises(ValueError, match="unknown probe backend"):
        tprobe.probe_lanes(store, *args[1:], "cam")
