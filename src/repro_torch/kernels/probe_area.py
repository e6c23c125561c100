"""Area-optimized HashMem probe (paper §2.1): wrapper of the CUDA kernel
``csrc/probe_area.cu``, which replaces the JAX package's Pallas kernel
``repro/kernels/probe_area.py:_make_kernel(strip)``.

``probe_pages_area(pool, queries, pages) -> (Q, 4) int32`` lanes
``[value, found, page, slot]``: the same function as ``probe_pages_perf``
(see ``ref.py``), computed one strip of ``min(128, S)`` slots at a time.
``S`` must be a multiple of the strip on either device, as the JAX kernel
asserts.  A pool on the CPU takes the plain version ``ref.probe_pages_ref``;
a pool on the card launches the kernel, or the call raises.
``probe_pages_area.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

STRIP = 128


@functools.cache
def _kernel_fn():
    """The C launcher, built and loaded on first use."""
    return build.launcher("probe_area", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p])


def probe_pages_area(pool: torch.Tensor, queries: torch.Tensor,
                     pages: torch.Tensor) -> torch.Tensor:
    S = pool.shape[1]
    strip = min(STRIP, S)
    if S % strip:
        raise ValueError(f"slots ({S}) must be a multiple of the strip "
                         f"width ({strip})")
    if pool.device.type == "cpu":
        return ref.probe_pages_ref(pool, queries, pages)
    if pool.device.type != "cuda":
        raise ValueError(f"probe_pages_area: unsupported device {pool.device}")
    P, S, qn, C = build.check_probe_args(pool, queries, pages)
    out = torch.empty((qn, 4), dtype=torch.int32, device=pool.device)
    fn = _kernel_fn()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pool.data_ptr(), queries.data_ptr(), pages.data_ptr(),
                 out.data_ptr(), qn, C, S, strip, P, stream)
    probe_pages_area.launches += 1
    if err != 0:
        raise RuntimeError(f"probe_area kernel launch failed: CUDA error {err}")
    return out


probe_pages_area.launches = 0
