"""Placement of a stacked HashMem on a serving mesh (the stacked-table part
of the JAX package's ``distributed/sharding.py``).

JAX shards every leaf of the stacked pytree over the mesh axis, one shard a
device.  On a ``ServingMesh`` the D shards stay stacked on its device:
placement puts every leaf there, contiguous, so a routed phase reads the
pool as one ``(D * P, S, 2)`` tensor.  On a ``RankMesh`` placement keeps
shard ``rank`` alone, a stack of one on the rank's device, as JAX leaves
each device its slice.  The model-sharding rules (``param_specs``,
``batch_spec``) are not ported yet: the port trains and decodes on one
card (ROADMAP Queue 1 item 16b).
"""
from __future__ import annotations

from repro_torch.core import hashmap
from repro_torch.launch.mesh import RankMesh


def stacked_hashmem_specs(hm_stacked, axis: str = "model") -> dict:
    """{leaf name: axis}: every leaf of a stacked table splits its leading
    axis over ``axis``, one shard a step along it."""
    return {name: axis for name in hashmap.leaf_names(hm_stacked.config)}


def shard_stacked_hashmem(mesh, hm_stacked, axis: str = "model"):
    """The stacked table of the mesh's D shards placed on the mesh: every
    leaf contiguous on the mesh's device (a ServingMesh), or only shard
    ``rank``'s leaves, a stack of one (a RankMesh).  Done once at build and
    growth time, so the per-tick calls start from a table in place."""
    D = mesh.shape[axis]
    if hm_stacked.bucket_head.dim() != 2 \
            or hm_stacked.bucket_head.shape[0] != D:
        raise ValueError(f"the mesh has {D} shards on {axis!r}; the table's "
                         f"bucket_head has shape "
                         f"{tuple(hm_stacked.bucket_head.shape)}")
    if isinstance(mesh, RankMesh):
        r = mesh.rank
        return hashmap._map_leaves(
            [hm_stacked],
            lambda ts: ts[0][r:r + 1].to(mesh.device).contiguous())
    return hashmap._map_leaves(
        [hm_stacked], lambda ts: ts[0].to(mesh.device).contiguous())
