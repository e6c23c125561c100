"""Sharding rules of the port (the JAX package's ``distributed/sharding.py``)
and the placement of a stacked HashMem on a serving mesh.

The rules map the logical axes of every parameter leaf (``model.
param_axes``) onto the axes of a mesh: data and fully sharded data
parallelism on ``("pod", "data")``, tensor parallelism on ``"model"``,
expert parallelism on ``"data"``, the paged KV pool over every axis (the
paper's channel parallelism, §2.5).  A rule is dropped (the dimension
replicated) where the dimension does not divide the axes' product:
whisper-tiny's 6 heads on a 16-way ``"model"`` axis, or 2 KV heads on 4.
They are pure functions of a mesh's shape, {axis: size} (a ``ModelMesh``,
or a bare shape such as ``launch.mesh.make_production_mesh()``); a spec
is a tuple with one entry a dimension, None, an axis or a tuple of axes,
trailing Nones dropped, as ``tuple(PartitionSpec)``.  ``local_block``
cuts a whole tensor to a rank's block of its spec.  ``ShardCtx``
(training's activation constraints) belongs to training over ranks
(ROADMAP Queue 1 item 16b-ii).

JAX shards every leaf of a stacked HashMem over the mesh axis, one shard a
device.  On a ``ServingMesh`` the D shards stay stacked on its device:
placement puts every leaf there, contiguous, so a routed phase reads the
pool as one ``(D * P, S, 2)`` tensor.  On a ``RankMesh`` placement keeps
shard ``rank`` alone, a stack of one on the rank's device, as JAX leaves
each device its slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import hashmap
from repro_torch.launch.mesh import RankMesh

# logical axis -> mesh axes (a tuple: joint sharding)
RULES = {
    "batch": ("pod", "data"),
    "embed": ("data",),          # FSDP weight shard
    "mlp": ("model",),           # TP
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "expert": ("data",),         # EP
    # paged-KV grouped layout: pages jointly sharded over the whole mesh
    # (batch groups x channels; paper §6 channel parallelism)
    "kv_pages": ("pod", "data", "model"),
    "act_seq": ("model",),       # sequence-parallel residual stream
    # replicated:
    "layers": (), "state": (), "conv": (), "dt_rank": (), "head_dim": (),
    "seq": (), "gates": (),
}
BATCH_AXES = ("pod", "data")


def mesh_shape(mesh) -> dict:
    """{axis: size} of a ``ModelMesh`` or of a bare shape."""
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


def mesh_axes_for(mesh, logical: str) -> tuple:
    shape = mesh_shape(mesh)
    return tuple(a for a in RULES.get(logical, ()) if a in shape)


def spec_for(mesh, axes, shape) -> tuple:
    """The spec of one array from its logical axes and shape, with the
    divisibility fallback to replication; an axis serves one dimension
    at most."""
    sizes = mesh_shape(mesh)
    parts, used = [], set()
    for name, dim in zip(tuple(axes), shape):
        maxes = tuple(a for a in mesh_axes_for(sizes, name) if a not in used)
        size = math.prod(sizes[a] for a in maxes)
        if maxes and dim % size == 0:
            parts.append(maxes if len(maxes) > 1 else maxes[0])
            used.update(maxes)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def param_specs(cfg, mesh) -> dict:
    """{JAX leaf path: spec} for ``model.init_params(cfg)``, a layer leaf
    with its leading ``"layers"`` dimension (never sharded)."""
    from repro_torch.models import model
    shapes = model.param_shapes(cfg)
    return {path: spec_for(mesh, axes, shapes[path])
            for path, axes in model.param_axes(cfg).items()}


def batch_spec(mesh, global_batch: int):
    """The batch dimension's entry: the batch axes of the mesh, or None
    where they do not divide the batch (long-context batch 1: the
    parallelism comes from the KV pages)."""
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in BATCH_AXES if a in sizes)
    if global_batch % math.prod(sizes[a] for a in axes) == 0:
        return axes
    return None


def batch_specs(cfg, mesh, batch_tree) -> dict:
    """Input specs of a train or prefill batch {name: array}: the leading
    dimension on the batch axes where they divide it (one axis named
    alone, as ``PartitionSpec`` keeps it)."""
    del cfg
    out = {}
    for k, v in batch_tree.items():
        b = batch_spec(mesh, v.shape[0])
        b = b[0] if b is not None and len(b) == 1 else b
        out[k] = (b,) + (None,) * (len(v.shape) - 1)
    return out


def entry_axes(entry) -> tuple:
    """A spec entry's mesh axes (none for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The block of the whole tensor ``t`` that ``mesh``'s rank holds under
    ``spec``: each sharded dimension cut into equal blocks, the rank's
    block the row-major index of its coordinates along the entry's
    axes (JAX's placement of a NamedSharding)."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        n = mesh.size(axes) if axes else 1
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(axes) * size, size)
    return t


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of an array of ``shape``."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in entry_axes(e))
                 for d, e in zip(shape, spec))


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
