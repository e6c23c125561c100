"""Builds the port's CUDA sources on first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, ``<name>_launch``.  It is
compiled by ``nvcc`` for ``sm_90a`` into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout (the
hash is of the source, so an edited source builds anew) and loaded with
``ctypes``.  A failed build or load raises; nothing falls back to another
path.  ``check_tensor`` and ``check_probe_args`` are the wrappers' checks
of what they pass by pointer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}     # name -> nvcc/ptxas output of its build


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_source(name: str) -> Path:
    """nvcc ``csrc/<name>.cu`` into its shared library, unless built."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{build_logs[name]}")
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(compile_source(name)))
    return _libs[name]


def launcher(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """``<name>_launch`` of ``csrc/<name>.cu``, typed; it returns the CUDA
    error code of its launch."""
    fn = getattr(load(name), f"{name}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_tensor(name: str, t: torch.Tensor, dtype, ndim: int, device):
    """Raise unless ``t`` is a contiguous ``ndim``-D ``dtype`` tensor on
    ``device``: the kernels take raw pointers."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the pool on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_probe_args(pool: torch.Tensor, queries: torch.Tensor,
                     pages: torch.Tensor):
    """The checks of the (P, S, 2) pool, (Q,) queries and (Q, C) schedule
    that every probe kernel takes; returns (P, S, Q, C)."""
    check_tensor("pool", pool, torch.int32, 3, pool.device)
    check_tensor("queries", queries, torch.int32, 1, pool.device)
    check_tensor("pages", pages, torch.int32, 2, pool.device)
    P, S, lanes = pool.shape
    qn, C = pages.shape
    if lanes != 2 or queries.shape[0] != qn:
        raise ValueError(f"shapes: pool {tuple(pool.shape)} queries "
                         f"{tuple(queries.shape)} pages {tuple(pages.shape)}")
    if P == 0 or pool.data_ptr() % 8:
        raise ValueError("pool must be non-empty and 8-byte aligned")
    return P, S, qn, C
