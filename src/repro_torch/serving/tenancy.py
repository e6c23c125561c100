"""Multi-tenant namespaces over one shared HashMem key space.

A tenant id is folded into the high bits of every key, so all tenants share
the same physical table (and therefore the same bucket/chain/bit-plane
machinery, arena, and probe kernels) while their key spaces are disjoint by
construction: fold(a, k1) == fold(b, k2) implies a == b and k1 == k2.  This
is the serving analogue of the paper's virtualization layer — isolation is a
property of the key encoding, not of per-tenant replicas, so one tenant's
deletes, tombstones, and auto-grow rebuilds can never alias another tenant's
entries (rebuilds re-bucket by the folded key; see tests/test_tenancy.py).
A copy of the JAX package's ``serving/tenancy.py`` (numpy only), kept so
that the port never imports ``repro``.

Sentinel safety: the folded key domain must stay strictly below 0xFFFFFFF0
(ROUTE_PAD) — HashMem reserves 0xFFFFFFFF (EMPTY) and 0xFFFFFFFE
(TOMBSTONE), and the RLU/engine use 0xFFFFFFF0..0xFFFFFFFD as routing/batch
padding: a key in that range would be silently treated as padding (never
stored, probes always miss).  The workload generators keep raw keys below
0xFFFFFFF0, and the top (all-ones) tenant id is unregistrable because its
folded range reaches up into the reserved region; ``max_tenants`` excludes
it.  ``fold`` enforces the reserved floor with a real exception (not an
assert), so a mis-sized custom TenantSpace can't smuggle a reserved key
into the table even under ``python -O``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

TENANT_BITS = 8                       # default: 254 usable tenants
_RAW_SENTINEL_FLOOR = 0xFFFFFFF0      # kv_synth keeps raw keys below this


class TenantSpace:
    """Key folding for ``bits``-bit tenant ids over 32-bit keys."""

    def __init__(self, bits: int = TENANT_BITS):
        assert 0 < bits < 16
        self.bits = bits
        self.key_bits = 32 - bits
        self.max_tenants = (1 << bits) - 1          # top id hits sentinels
        self.key_space = 1 << self.key_bits

    def fold(self, tenant_id: int, keys):
        """(tenant_id, keys) -> folded uint32 keys (vectorized).  Raises
        ValueError when a tenant id or key is out of range, or when a
        folded key would land in the reserved pad/sentinel range
        [0xFFFFFFF0, 0xFFFFFFFF] (see module docstring)."""
        if not 0 <= tenant_id < self.max_tenants:
            raise ValueError(
                f"tenant id {tenant_id} out of range [0, {self.max_tenants})")
        keys = np.asarray(keys, np.uint64)
        if keys.size and not (keys < self.key_space).all():
            raise ValueError(f"tenant keys must fit {self.key_bits} bits")
        folded = ((np.uint64(tenant_id) << np.uint64(self.key_bits)) | keys) \
            .astype(np.uint32)
        if folded.size and int(folded.max()) >= _RAW_SENTINEL_FLOOR:
            raise ValueError(
                f"folded key {int(folded.max()):#x} collides with the "
                f"reserved pad/sentinel range "
                f"[{_RAW_SENTINEL_FLOOR:#x}, 0xffffffff]")
        return folded

    def unfold(self, folded):
        """Folded uint32 keys -> (tenant_ids, raw keys)."""
        folded = np.asarray(folded, np.uint64)
        return (folded >> np.uint64(self.key_bits)).astype(np.uint32), \
            (folded & np.uint64(self.key_space - 1)).astype(np.uint32)


@dataclass
class Tenant:
    """One tenant: identity plus admission-control quotas.

    ``max_slots`` bounds the tenant's concurrent in-flight requests (slot
    occupancy quota); ``max_pending`` bounds its queued backlog.  Either can
    be 0 for "no per-tenant bound" (the engine's global bounds still apply).
    """
    tid: int
    name: str = ""
    max_slots: int = 0
    max_pending: int = 0
    stats: dict = field(default_factory=lambda: {
        "submitted": 0, "rejected": 0, "queued": 0, "admitted": 0,
        "completed": 0, "killed": 0,
        "ops": {"read": 0, "update": 0, "insert": 0, "delete": 0,
                "scan": 0, "rmw": 0},
        "hits": 0, "misses": 0,
        # wall-time sums over COMPLETED requests: submit->admit (queue)
        # and admit->complete (service) — per-tenant view of the engine's
        # queue/service latency split (metrics.py histograms hold the
        # engine-wide quantiles)
        "queue_secs": 0.0, "service_secs": 0.0,
    })


class TenantRegistry:
    """Registered tenants + the shared key-folding space."""

    def __init__(self, bits: int = TENANT_BITS):
        self.space = TenantSpace(bits)
        self.tenants: dict[int, Tenant] = {}

    def register(self, name: str = "", max_slots: int = 0,
                 max_pending: int = 0, tid: int | None = None) -> Tenant:
        if tid is None:
            tid = len(self.tenants)
            while tid in self.tenants:
                tid += 1
        assert tid not in self.tenants, f"tenant {tid} already registered"
        assert 0 <= tid < self.space.max_tenants, \
            f"tenant id {tid} out of range [0, {self.space.max_tenants})"
        t = Tenant(tid=tid, name=name or f"tenant{tid}",
                   max_slots=max_slots, max_pending=max_pending)
        self.tenants[tid] = t
        return t

    def __getitem__(self, tid: int) -> Tenant:
        return self.tenants[tid]

    def __iter__(self):
        return iter(self.tenants.values())

    def fold(self, tid: int, keys):
        return self.space.fold(tid, keys)

    def stats(self) -> dict:
        return {t.name: {**t.stats, "ops": dict(t.stats["ops"])}
                for t in self}
