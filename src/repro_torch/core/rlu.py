"""RLU routing between requests and HashMem shards: the host part of the
JAX package's ``core/rlu.py``.

One global hash h(key) decides which shard owns a key; two routers are
supported (``shard_by``):

    "mod"       owner = h mod D
    "highbits"  owner = ((h >> 16) * D) >> 16   (fastrange over the top
                                                 16 bits, any D)

A "highbits" shard is an ordinary HashMem whose keys happen to route to it:
its local bucket is the plain ``hash_to_bucket`` of the full key, so every
host shard grows, compacts and probes on its own.  The serving engine's
host shards partition each coalesced phase with ONE vectorized
``owner_of_np`` call.

Only the host router is here.  The device routers (``owner_of``,
``owner_and_local_bucket``), the routed all-to-all calls (``_Route``,
``probe_sharded``, ``delete_sharded``, ``insert_mesh``, ``tick_mesh``) and
the sharded build wait for the mesh backend (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import HashMemConfig

# Routing pad: below every sentinel, above every workload/tenant-folded key
# (kv_synth keeps raw keys < 0xFFFFFFF0 and tenancy.py reserves the top
# tenant id), so a padded slot probes/deletes nothing and an insert treats
# it as invalid -- shared with the serving engine's batch pad.
ROUTE_PAD = np.uint32(0xFFFFFFF0)

SHARD_ROUTERS = ("mod", "highbits")


def owner_of_np(keys, cfg: HashMemConfig, num_shards: int,
                shard_by: str = "mod") -> np.ndarray:
    """(N,) uint32 keys -> (N,) int32 owner shard ids under the chosen
    router, in numpy uint32 arithmetic (the same hash as
    ``core/hashing.py``), so a whole coalesced batch is partitioned without
    touching the device."""
    k = np.asarray(keys, np.uint32)
    if cfg.hash_fn == "murmur3_fmix":
        h = k ^ np.uint32(cfg.salt)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    elif cfg.hash_fn == "mult_shift":
        h = (k * np.uint32(2654435761)) ^ np.uint32(cfg.salt)
    else:                                   # identity
        h = k
    if shard_by == "highbits":
        return (((h >> np.uint32(16)) * np.uint32(num_shards))
                >> np.uint32(16)).astype(np.int32)
    assert shard_by == "mod", shard_by
    return (h % np.uint32(num_shards)).astype(np.int32)
