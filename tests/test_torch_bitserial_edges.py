"""The bit-serial kernel's edge cases on the CPU, and the yardstick its time
is judged by.

``chip_smoke.bitserial_cases`` are the cases ``chip_smoke.py`` holds the
CUDA kernel to on the card: the edges of its walk one 256-slot chunk (one
32-byte sector of each plane) at a time, and random tables at key widths
1/4/8/13/16/31/32.  Here the same numpy-built cases go through the port's
plain version (``ops.probe_bitserial`` on CPU tensors) and the JAX
package's ``repro.kernels.ref.probe_bitplanes_ref``; both must equal the
numpy loop over the lane contract on the masked keys.  The JAX side
(interleave, ``pack_bitplanes``, the reference) runs under one ``jax.jit``
per shape and width, which costs a fraction of its op-by-op compiles.  All
state is integer, so every comparison is exact (tolerance 0).

``chip_smoke.plane_bound`` counts the bytes a bit-serial probe needs; it is
checked here on hand-built (pages, out) lanes, sector by sector.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jlayout
from repro.kernels import ref as jref

from repro_torch.core import layout as tlayout
from repro_torch.kernels import ops

from backends_cases import masked
from probe_cases import lanes_oracle, t_pages, t_pool, t_q
import torch_threads

one_thread = torch_threads.one_thread

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CASES = {name: (case, b) for name, case, b in chip_smoke.bitserial_cases()}


@functools.partial(jax.jit, static_argnums=4)
def jax_bitserial(kp, vp, q, pages, key_bits):
    """JAX's planes and (values, found) of its bit-serial reference."""
    pool = jlayout.interleave(kp, vp)
    planes = jlayout.pack_bitplanes(pool[..., 0], key_bits)
    return (planes,) + jref.probe_bitplanes_ref(planes, pool, q, pages,
                                                key_bits)


@pytest.mark.parametrize("name", list(CASES))
def test_bitserial_case_matches_jax(name):
    (kp, vp, q, pages), b = CASES[name]
    pool = t_pool(kp, vp)
    planes = tlayout.pack_bitplanes(pool[..., 0], b)
    got = ops.probe_bitserial(planes, pool, t_q(q), t_pages(pages), b)
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, lanes_oracle(masked(kp, b), vp, masked(q, b), pages))
    jplanes, v, f = jax_bitserial(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(q), jnp.asarray(pages), b)
    np.testing.assert_array_equal(planes.numpy().view(np.uint32),
                                  np.asarray(jplanes))
    np.testing.assert_array_equal(got[:, 0], np.asarray(v))
    np.testing.assert_array_equal(got[:, 1] != 0, np.asarray(f))
    if name.startswith("sector_edges"):
        S = kp.shape[1]
        hits = [None if r[1] == 0 else (int(r[2]), int(r[3])) for r in got]
        assert hits == chip_smoke.sector_edge_hits(S)


SECTOR = 32
B, W = 32, 16                   # the paper's planes: 32 x 16 words a page
ROW = B * W * 4                 # one whole plane row, 2 KiB


def lanes(*hits):
    """(Q, 4) int32 lanes [value, found, page, slot]; None is a miss."""
    return torch.tensor([[7, 1, p, s] if (p, s) != (None, None) else
                         [0, 0, 0, 0] for p, s in hits], dtype=torch.int32)


@pytest.mark.parametrize("sched,hit,rows,sectors", [
    ([4, -1, -1], (4, 0), 0, 1),            # hit in word 0
    ([4, -1, -1], (4, 7 * 32 + 31), 0, 1),  # word 7: still the first sector
    ([4, -1, -1], (4, 8 * 32), 0, 2),       # word 8: the second sector
    ([4, -1, -1], (4, 15 * 32 + 5), 0, 2),  # word 15, the last
    ([4, 5, -1], (None, None), 2, 0),       # a miss: every valid step's row
    ([-1, 4, -1], (4, 9 * 32), 0, 2),       # a hit after a skipped step
    ([3, 4, -1], (4, 3 * 32), 1, 1),        # a hit after a full-row miss
    ([3, -1, 4], (4, 8 * 32), 1, 2),        # both, then the second sector
])
def test_plane_bound_counts_sectors(sched, hit, rows, sectors):
    """Whole plane rows for the steps walked before the hit; on the hit
    step each of the b planes up to the hit's word in 32-byte sectors, and
    one value sector; the I/O bytes as given."""
    pages = torch.tensor([sched], dtype=torch.int32)
    out = lanes(hit)
    found = hit != (None, None)
    nbytes, ops_, _ = chip_smoke.plane_bound(pages, out, B, W, io_bytes=100)
    want = rows * ROW + sectors * SECTOR * B + found * SECTOR + 100
    assert nbytes == want
    hit_words = hit[1] // 32 + 1 if found else 0
    assert ops_ == 2 * B * (rows * W + hit_words)


def test_plane_bound_sums_over_queries():
    pages = torch.tensor([[4, -1], [3, 4], [5, 6]], dtype=torch.int32)
    out = lanes((4, 0), (4, 8 * 32), (None, None))
    nbytes, _, _ = chip_smoke.plane_bound(pages, out, B, W, io_bytes=0)
    assert nbytes == (1 * SECTOR * B + SECTOR) \
        + (ROW + 2 * SECTOR * B + SECTOR) + 2 * ROW
