"""The directed cases of the port's ``area`` and ``bitserial`` probe backends
against the JAX package's oracles (alone, to keep the file fast): first
match in chain order, interior holes, sentinel queries, and a page past the
pool. Tolerance 0."""
import numpy as np
import pytest

from test_kernels_probe import make_pool, make_queries
import torch_threads
from backends_cases import check_backend

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("backend", ["area", "bitserial"])
def test_first_match_chain_order(backend):
    """Duplicate key on two pages: the first page in chain order wins, even
    over a lower slot on a later page; within a row the lowest slot."""
    kp = np.full((4, 256), 0xFFFFFFFF, np.uint32)
    vp = np.arange(1024, dtype=np.uint32).reshape(4, 256)
    kp[1, 200] = 42; kp[3, 77] = 42; kp[3, 9] = 42
    kp[0, [250, 131, 64, 33]] = 7
    q = np.array([42, 42, 7], np.uint32)
    pages = np.array([[1, 3], [3, 1], [-1, 0]], np.int32)
    got = check_backend(backend, kp, vp, q, pages, interpret=False)
    assert got.tolist() == [[456, 1, 1, 200], [777, 1, 3, 9], [33, 1, 0, 33]]


@pytest.mark.parametrize("backend", ["area", "bitserial"])
def test_interior_holes(backend):
    """-1 steps anywhere in the schedule, leading ones included."""
    rng = np.random.default_rng(17)
    P, S, Q, C = 32, 256, 64, 4
    kp, vp, live = make_pool(rng, P, S)
    q, pages = make_queries(rng, kp, vp, live, Q, C, P)
    holes = rng.random(pages.shape) < 0.3
    for i in range(Q // 2):                # keep each hit's own page
        hp = np.flatnonzero(kp[np.maximum(pages[i], 0)] == q[i])
        holes[i, hp // S] = False
    pages[holes] = -1
    pages[::5, 0] = -1
    got = check_backend(backend, kp, vp, q, pages)
    assert got[:, 1].sum() >= Q // 4


@pytest.mark.parametrize("backend", ["area", "bitserial"])
def test_sentinel_queries_match_as_in_jax(backend):
    """No extra filter: EMPTY_KEY matches an empty slot and TOMBSTONE_KEY a
    tombstone, as in the JAX package."""
    kp = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    vp = np.arange(512, dtype=np.uint32).reshape(4, 128)
    kp[1, :40] = np.arange(40) + 1000
    kp[3, 6] = 0xFFFFFFFE
    q = np.array([0xFFFFFFFF, 0xFFFFFFFE], np.uint32)
    pages = np.array([[-1, 1], [1, 3]], np.int32)
    got = check_backend(backend, kp, vp, q, pages, interpret=False)
    assert got.tolist() == [[168, 1, 1, 40], [390, 1, 3, 6]]


@pytest.mark.parametrize("backend", ["area", "bitserial"])
def test_page_past_pool_reads_last_row_as_jax(backend):
    kp = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    vp = np.zeros((4, 128), np.uint32)
    kp[3, 17] = 5; vp[3, 17] = 99
    got = check_backend(backend, kp, vp, np.array([5], np.uint32),
                        np.array([[0, 9]], np.int32), interpret=False)
    assert got[0].tolist() == [99, 1, 9, 17]
