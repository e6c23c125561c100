"""Probe entry points of the port (the JAX package's ``kernels/ops.py``).

The names exist for parity with the JAX package, where ``core/probe.py``
reaches its kernels through ``ops``; the wrappers themselves do the device
dispatch.

Both take the interleaved (P, S, 2) int32 pool, (Q,) int32 queries and a
(Q, C) int32 page schedule, and return the (Q, 4) int32 lanes
``[value, found, page, slot]``:

  * ``probe_perf``: the CUDA kernel for a pool on the card, the plain
    version for a pool on the CPU;
  * ``probe_ref``: the plain version on either device.
"""
from __future__ import annotations

from repro_torch.kernels.probe_perf import probe_pages_perf
from repro_torch.kernels.ref import probe_pages_ref

__all__ = ["probe_perf", "probe_ref"]

probe_perf = probe_pages_perf
probe_ref = probe_pages_ref
