"""Performance-optimized HashMem probe (paper §2.2): wrapper of the CUDA
kernel ``csrc/probe_perf.cu``, which replaces the JAX package's Pallas
kernel ``repro/kernels/probe_perf.py:_kernel``.

``probe_pages_perf(pool, queries, pages) -> (Q, 4) int32`` lanes
``[value, found, page, slot]`` (see ``ref.py`` for the contract).  A pool on
the CPU takes the plain version in ``ref.py``; a pool on the card launches
the kernel, or the call raises.  ``probe_pages_perf.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


@functools.cache
def _kernel_fn():
    """The C launcher, built and loaded on first use."""
    fn = build.load("probe_perf").probe_perf_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the pool on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def probe_pages_perf(pool: torch.Tensor, queries: torch.Tensor,
                     pages: torch.Tensor) -> torch.Tensor:
    if pool.device.type == "cpu":
        return ref.probe_pages_ref(pool, queries, pages)
    if pool.device.type != "cuda":
        raise ValueError(f"probe_pages_perf: unsupported device {pool.device}")
    _check("pool", pool, torch.int32, 3, pool.device)
    _check("queries", queries, torch.int32, 1, pool.device)
    _check("pages", pages, torch.int32, 2, pool.device)
    P, S, lanes = pool.shape
    qn, C = pages.shape
    if lanes != 2 or queries.shape[0] != qn:
        raise ValueError(f"shapes: pool {tuple(pool.shape)} queries "
                         f"{tuple(queries.shape)} pages {tuple(pages.shape)}")
    if P == 0 or pool.data_ptr() % 8:
        raise ValueError("pool must be non-empty and 8-byte aligned")
    out = torch.empty((qn, 4), dtype=torch.int32, device=pool.device)
    fn = _kernel_fn()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pool.data_ptr(), queries.data_ptr(), pages.data_ptr(),
                 out.data_ptr(), qn, C, S, P, stream)
    probe_pages_perf.launches += 1
    if err != 0:
        raise RuntimeError(f"probe_perf kernel launch failed: CUDA error {err}")
    return out


probe_pages_perf.launches = 0
