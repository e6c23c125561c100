"""Parity of the port's ``area`` and ``bitserial`` probe backends with the
JAX package: the plain versions the CPU runs (``probe_pages_ref`` for the
area kernel, ``probe_bitplanes_ref`` for the bit-serial one) against JAX's
oracles and its Pallas ``probe_pages_area`` / ``probe_pages_bitserial`` in
interpret mode (the directed cases take JAX's oracles alone, to keep the
file fast), and against a numpy loop over the lane contract; then the
dispatch rules.  All state is integer, so every comparison is exact
(tolerance 0).  The CUDA kernels are held against these plain versions on
the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jlayout
from repro.kernels import ref as jref
from repro.kernels.probe_area import probe_pages_area as jax_area
from repro.kernels.probe_bitserial import probe_pages_bitserial as jax_bits

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout
from repro_torch.core import probe as tprobe
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.probe_area import probe_pages_area
from repro_torch.kernels.probe_bitserial import probe_pages_bitserial
from repro_torch.kernels.probe_perf import probe_pages_perf

from test_kernels_probe import make_pool, make_queries
from test_torch_probe import SHAPES, lanes_oracle, t_pages, t_pool, t_q
import torch_threads

one_thread = torch_threads.one_thread

KERNELS = (probe_pages_perf, probe_pages_area, probe_pages_bitserial)


def masked(a, key_bits):
    return a & np.uint32((1 << key_bits) - 1) if key_bits < 32 else a


def port_lanes(backend, kp, vp, q, pages, key_bits=32):
    """The port's (Q, 4) lanes as uint32, through the ops entry point."""
    pool, tq, tp = t_pool(kp, vp), t_q(q), t_pages(pages)
    if backend == "area":
        out = ops.probe_area(pool, tq, tp)
    else:
        planes = tlayout.pack_bitplanes(pool[..., 0], key_bits)
        out = ops.probe_bitserial(planes, pool, tq, tp, key_bits)
    return out.numpy().view(np.uint32)


def jax_results(backend, kp, vp, q, pages, key_bits=32, interpret=True):
    """(values, found) of the JAX oracle and, with ``interpret``, of the
    Pallas kernel in interpret mode."""
    pool = jlayout.interleave(jnp.asarray(kp), jnp.asarray(vp))
    jq, jp = jnp.asarray(q), jnp.asarray(pages)
    if backend == "area":
        outs = [jref.probe_pages_ref(pool, jq, jp)]
        if interpret:
            outs.append(jax_area(pool, jq, jp, interpret=True))
    else:
        planes = jlayout.pack_bitplanes(pool[..., 0], key_bits)
        outs = [jref.probe_bitplanes_ref(planes, pool, jq, jp, key_bits)]
        if interpret:
            outs.append(jax_bits(planes, pool, jq, jp, key_bits,
                                 interpret=True))
    return outs


def check_backend(backend, kp, vp, q, pages, key_bits=32, interpret=True):
    got = port_lanes(backend, kp, vp, q, pages, key_bits)
    want = lanes_oracle(masked(kp, key_bits), vp, masked(q, key_bits), pages)
    np.testing.assert_array_equal(got, want)
    for v, f in jax_results(backend, kp, vp, q, pages, key_bits, interpret):
        np.testing.assert_array_equal(got[:, 1] != 0, np.asarray(f))
        np.testing.assert_array_equal(got[:, 0], np.asarray(v))
    return got


@pytest.mark.parametrize("backend", ["area", "bitserial"])
@pytest.mark.parametrize("P,S,Q,C", SHAPES)
def test_plain_versions_match_jax(backend, P, S, Q, C):
    rng = np.random.default_rng(P * 1000 + S + Q + C)
    kp, vp, live = make_pool(rng, P, S)
    q, pages = make_queries(rng, kp, vp, live, Q, C, P)
    got = check_backend(backend, kp, vp, q, pages)
    assert got[:, 1].sum() >= Q // 2


@pytest.mark.parametrize("key_bits", [4, 8, 16, 32])
def test_bitserial_key_widths(key_bits):
    """The paper's column widths: the compare sees the low key_bits bits
    only, as the TPU kernel does."""
    rng = np.random.default_rng(key_bits)
    P, S, Q, C = 8, 128, 32, 2
    kp, vp, live = make_pool(rng, P, S, key_bits=key_bits, fill=0.4)
    q, pages = make_queries(rng, kp, vp, live, Q, C, P, key_bits=key_bits)
    check_backend("bitserial", kp, vp, q, pages, key_bits)
    # a query that differs from a stored key only above bit key_bits
    if key_bits < 32:
        hi = q[:1] | np.uint32(1 << key_bits)
        got = check_backend("bitserial", kp, vp, hi, pages[:1], key_bits,
                            interpret=False)
        assert got[0, 1] == 1


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


def test_bitplanes_ref_chunks_agree(monkeypatch):
    rng = np.random.default_rng(11)
    kp, vp, live = make_pool(rng, 32, 256)
    q, pages = make_queries(rng, kp, vp, live, 97, 4, 32)
    pool = t_pool(kp, vp)
    planes = tlayout.pack_bitplanes(pool[..., 0], 32)
    args = planes, pool, t_q(q), t_pages(pages), 32
    whole = tref.probe_bitplanes_ref(*args)
    monkeypatch.setattr(tref, "GATHER_BYTES", 5 * 4 * 32 * 8 * 4)  # 5 queries
    assert torch.equal(tref.probe_bitplanes_ref(*args), whole)


def _store(kp, vp, key_bits=None):
    pool = t_pool(kp, vp)
    P = kp.shape[0]
    planes = None if key_bits is None else \
        tlayout.pack_bitplanes(pool[..., 0], key_bits)
    return tlayout.PageStore(
        pool=pool, page_next=torch.full((P,), -1, dtype=torch.int32),
        page_fill=torch.zeros(P, dtype=torch.int32),
        free_top=torch.tensor(P, dtype=torch.int32),
        key_bits=key_bits or 32, planes=planes)


def test_cpu_dispatch_never_launches_a_kernel():
    rng = np.random.default_rng(5)
    kp, vp, live = make_pool(rng, 16, 128)
    q, pages = make_queries(rng, kp, vp, live, 32, 2, 16)
    store = _store(kp, vp, key_bits=32)
    want = tref.probe_pages_ref(store.pool, t_q(q), t_pages(pages))
    before = [k.launches for k in KERNELS]
    for backend in ("ref", "perf", "area", "bitserial"):
        got = tprobe.probe_lanes(store, t_q(q), t_pages(pages), backend)
        assert torch.equal(got, want), backend
    cfg = HashMemConfig(num_buckets=8, slots_per_page=32, overflow_pages=8,
                        max_chain=3, backend="bitserial")
    hm = thm.build(cfg, q, q, device="cpu")
    for backend in ("ref", "perf", "area", "bitserial"):
        thm.probe(hm, q, backend=backend)
    thm.delete(hm, q[:4])
    assert [k.launches for k in KERNELS] == before


def test_bitserial_without_planes_raises():
    rng = np.random.default_rng(6)
    kp, vp, live = make_pool(rng, 8, 128)
    q, pages = make_queries(rng, kp, vp, live, 8, 2, 8)
    with pytest.raises(ValueError, match="requires planes"):
        tprobe.probe_lanes(_store(kp, vp), t_q(q), t_pages(pages),
                           "bitserial")
    cfg = HashMemConfig(num_buckets=8, slots_per_page=128, overflow_pages=8,
                        max_chain=3, backend="perf")
    hm = thm.build(cfg, q, q, device="cpu")
    with pytest.raises(ValueError, match="requires planes"):
        thm.probe(hm, q, backend="bitserial")
    with pytest.raises(ValueError, match="unknown probe backend"):
        tprobe.probe_lanes(_store(kp, vp), t_q(q), t_pages(pages), "cam")


def test_area_refuses_slots_not_multiple_of_strip():
    """S = 200 is not a multiple of the 128-slot strip (JAX asserts); below
    128 slots the strip is the whole row."""
    kp = np.full((4, 200), 0xFFFFFFFF, np.uint32)
    args = t_pool(kp, kp), t_q(np.array([1], np.uint32)), \
        t_pages(np.array([[0]], np.int32))
    with pytest.raises(ValueError, match="multiple of the strip"):
        probe_pages_area(*args)
    assert torch.equal(probe_pages_perf(*args), tref.probe_pages_ref(*args))
    kp = np.full((4, 96), 0xFFFFFFFF, np.uint32)
    kp[2, 50] = 1
    got = probe_pages_area(t_pool(kp, kp), args[1], t_pages(
        np.array([[2]], np.int32)))
    assert got.numpy().view(np.uint32).tolist() == [[1, 1, 2, 50]]


def test_bitserial_refuses_planes_that_do_not_fit():
    kp = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    pool = t_pool(kp, kp)
    q, pages = t_q(np.array([1], np.uint32)), t_pages(np.zeros((1, 1),
                                                               np.int32))
    planes = tlayout.pack_bitplanes(pool[..., 0], 16)
    with pytest.raises(ValueError, match="do not fit"):
        probe_pages_bitserial(planes, pool, q, pages, 32)
    with pytest.raises(ValueError, match="do not fit"):
        probe_pages_bitserial(planes[:, :, :2].contiguous(), pool, q, pages,
                              16)
