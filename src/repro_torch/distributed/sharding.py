"""Placement of a stacked HashMem on the serving mesh (the stacked-table
part of the JAX package's ``distributed/sharding.py``).

JAX shards every leaf of the stacked pytree over the mesh axis, one shard a
device.  On one card the D shards stay stacked: placement puts every leaf
on the mesh's device, contiguous, so a routed phase reads the pool as one
``(D * P, S, 2)`` tensor.  The model-sharding rules (``param_specs``,
``batch_spec``) are not ported: the port trains and decodes on one card
(a multi-card backend is ROADMAP Queue 1 item 16).
"""
from __future__ import annotations

from repro_torch.core import hashmap


def stacked_hashmem_specs(hm_stacked, axis: str = "model") -> dict:
    """{leaf name: axis}: every leaf of a stacked table splits its leading
    axis over ``axis``, one shard a step along it."""
    return {name: axis for name in hashmap.leaf_names(hm_stacked.config)}


def shard_stacked_hashmem(mesh, hm_stacked, axis: str = "model"):
    """The stacked table with every leaf contiguous on the mesh's device.
    Done once at build and growth time, so the per-tick calls start from a
    table in place."""
    D = mesh.shape[axis]
    if hm_stacked.bucket_head.dim() != 2 \
            or hm_stacked.bucket_head.shape[0] != D:
        raise ValueError(f"the mesh has {D} shards on {axis!r}; the table's "
                         f"bucket_head has shape "
                         f"{tuple(hm_stacked.bucket_head.shape)}")
    return hashmap._map_leaves(
        [hm_stacked], lambda ts: ts[0].to(mesh.device).contiguous())
