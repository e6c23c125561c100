"""Bit-serial HashMem probe (paper §2.2, column-oriented keys): wrapper of
the CUDA kernel ``csrc/probe_bitserial.cu``, which replaces the JAX
package's Pallas kernel ``repro/kernels/probe_bitserial.py:_make_kernel``.

``probe_pages_bitserial(planes, pool, queries, pages, key_bits) -> (Q, 4)
int32`` lanes ``[value, found, page, slot]``.  ``planes`` is the
``(P, key_bits, S // 32)`` int32 bit-plane lane of the pool's keys
(``layout.pack_bitplanes``); a slot matches when its low ``key_bits`` key
bits equal the query's.  Only the pool's value lane is read.  The shapes are
checked on either device, as the JAX kernel asserts them.  Planes on the CPU
take the plain version ``ref.probe_bitplanes_ref``; planes on the card
launch the kernel, or the call raises.  ``probe_pages_bitserial.launches``
counts the kernel's launches.  ``load_width(planes)`` says whether the
kernel reads these planes with 16-byte or 4-byte loads.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


@functools.cache
def _kernel_fn():
    """The C launcher, built and loaded on first use."""
    return build.launcher("probe_bitserial", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])


def load_width(planes: torch.Tensor) -> int:
    """Bytes per plane load the kernel takes on these card planes, by the
    rule of ``probe_bitserial_launch``: 16 where W % 4 == 0 and the planes
    are 16-byte aligned, else 4."""
    return 16 if planes.shape[2] % 4 == 0 and planes.data_ptr() % 16 == 0 \
        else 4


def probe_pages_bitserial(planes: torch.Tensor, pool: torch.Tensor,
                          queries: torch.Tensor, pages: torch.Tensor,
                          key_bits: int) -> torch.Tensor:
    P, b, W = planes.shape
    if not 1 <= key_bits <= 32 or b != key_bits or pool.shape[0] != P \
            or pool.shape[1] != 32 * W:
        raise ValueError(f"planes {tuple(planes.shape)} do not fit pool "
                         f"{tuple(pool.shape)} at key_bits={key_bits}")
    if planes.device.type == "cpu":
        return ref.probe_bitplanes_ref(planes, pool, queries, pages, key_bits)
    if planes.device.type != "cuda":
        raise ValueError(f"probe_pages_bitserial: unsupported device "
                         f"{planes.device}")
    dev = planes.device
    build.check_tensor("planes", planes, torch.int32, 3, pool.device)
    _, _, qn, C = build.check_probe_args(pool, queries, pages)
    out = torch.empty((qn, 4), dtype=torch.int32, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(planes.data_ptr(), pool.data_ptr(), queries.data_ptr(),
                 pages.data_ptr(), out.data_ptr(), qn, C, W, key_bits, P,
                 stream)
    probe_pages_bitserial.launches += 1
    if err != 0:
        raise RuntimeError(f"probe_bitserial kernel launch failed: CUDA "
                           f"error {err}")
    return out


probe_pages_bitserial.launches = 0
