"""Probe and bit-plane entry points of the port (the JAX package's
``kernels/ops.py``).

The names exist for parity with the JAX package, where ``core/probe.py``
and the mutation engine reach their kernels through ``ops``; the wrappers
themselves do the device dispatch.

The probes take the interleaved (P, S, 2) int32 pool, (Q,) int32 queries
and a (Q, C) int32 page schedule, and return the (Q, 4) int32 lanes
``[value, found, page, slot]``:

  * ``probe_perf``, ``probe_area``: the CUDA kernels for a pool on the card,
    the plain version for a pool on the CPU;
  * ``probe_bitserial(planes, pool, queries, pages, key_bits)``: the CUDA
    kernel on the bit-planes, or their plain version on the CPU;
  * ``probe_ref``, ``probe_bitplanes_ref``: the plain versions on either
    device.

``bitplane_update`` (insert and delete write sets) and ``bitplane_rebuild``
(grow and compact) keep the bit-plane lane.
"""
from __future__ import annotations

from repro_torch.core.layout import pack_bitplanes, update_bitplanes_batch
from repro_torch.kernels.probe_area import probe_pages_area
from repro_torch.kernels.probe_bitserial import probe_pages_bitserial
from repro_torch.kernels.probe_perf import probe_pages_perf
from repro_torch.kernels.ref import probe_bitplanes_ref, probe_pages_ref

__all__ = ["probe_perf", "probe_area", "probe_bitserial", "probe_ref",
           "probe_bitplanes_ref", "bitplane_update", "bitplane_rebuild"]

probe_perf = probe_pages_perf
probe_area = probe_pages_area
probe_bitserial = probe_pages_bitserial
probe_ref = probe_pages_ref
bitplane_update = update_bitplanes_batch
bitplane_rebuild = pack_bitplanes
