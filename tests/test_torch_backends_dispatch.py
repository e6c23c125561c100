"""The port's ``bitserial`` backend at every key width against the JAX package,
its plane reference in chunks, and the backends' dispatch rules and
refusals. Tolerance 0."""
import numpy as np
import pytest
import torch

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout
from repro_torch.core import probe as tprobe
from repro_torch.kernels import ref as tref
from repro_torch.kernels.probe_area import probe_pages_area
from repro_torch.kernels.probe_bitserial import probe_pages_bitserial
from repro_torch.kernels.probe_perf import probe_pages_perf

from test_kernels_probe import make_pool, make_queries
from probe_cases import t_pages, t_pool, t_q
import torch_threads
from backends_cases import check_backend

one_thread = torch_threads.one_thread

KERNELS = (probe_pages_perf, probe_pages_area, probe_pages_bitserial)


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
