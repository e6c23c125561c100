"""The directed cases of the port's plain probe against the JAX package's:
first match in chain order, the lowest slot of a row, interior holes,
sentinel queries, and a page past the pool. Tolerance 0."""
import numpy as np
import pytest

from test_kernels_probe import make_pool, make_queries
import torch_threads
from probe_cases import check_all

one_thread = torch_threads.one_thread


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
