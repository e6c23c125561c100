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
cuts a whole tensor to a rank's block of its spec.  ``ShardCtx`` is
training's activation layout over a ``ModelMesh`` (JAX's activation
constraints).

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


def full_tensor(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block under its
    ``.spec``: each sharded dimension all-gathered over its axes (every
    rank of the mesh must call it; no gradient)."""
    for dim, entry in enumerate(getattr(t, "spec", ())):
        axes = entry_axes(entry)
        if axes and mesh.size(axes) > 1:
            t = mesh.all_gather(t, axes, dim)
    return t


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of an array of ``shape``."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in entry_axes(e))
                 for d, e in zip(shape, spec))


def whole_shape(shape, spec, mesh) -> tuple:
    """The shape of the array of which a rank's block has ``shape`` (the
    inverse of ``local_shape``)."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d * math.prod(sizes[a] for a in entry_axes(e))
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


class ShardCtx:
    """Training's activation layout over a ``launch.mesh.ModelMesh`` (JAX's
    ``ShardCtx``, ``src/repro/distributed/sharding.py:118-140``).  JAX's
    ``residual`` is a sharding constraint GSPMD meets; here it is the
    layout each rank holds.  ``bind(B, S)`` fixes it for a global batch of
    B sequences of S positions:

      * ``batch_axes``: the batch axes the batch shards over
        (``batch_spec``), or none where they do not divide it (every batch
        group then holds the whole batch);
      * ``seq``: with ``seq_shard`` and S a multiple of the ``"model"``
        size, the residual stream between units is this rank's (B_loc,
        S / |model|, d) block (Megatron's sequence parallelism), gathered
        before the column-parallel products and reduce-scattered after the
        row-parallel ones; otherwise it is (B_loc, S, d), the same on every
        ``"model"`` rank, and the row-parallel products are all-reduced.
    """

    def __init__(self, mesh, seq_shard: bool = False):
        self.mesh = mesh
        self.seq_shard = seq_shard
        self._baxes = tuple(a for a in BATCH_AXES if a in mesh.shape)
        self.model_size = mesh.shape.get("model", 1)
        self.batch_axes: tuple = ()
        self.seq = False

    def bind(self, B: int, S: int) -> "ShardCtx":
        ctx = ShardCtx(self.mesh, self.seq_shard)
        ctx.batch_axes = self._baxes if batch_spec(self.mesh, B) else ()
        ctx.seq = bool(self.seq_shard and self.model_size > 1
                       and S % self.model_size == 0)
        return ctx

    @property
    def copies(self) -> int:
        """The ranks that hold the same tokens (the loss's replicas)."""
        return self.mesh.num_shards // self.mesh.size(self.batch_axes)

    def local_batch(self, batch: dict) -> dict:
        """Each input's block of this rank's batch group, on the mesh's
        device (the whole batch where it does not shard)."""
        entry = self.batch_axes or None
        return {k: local_block(torch.as_tensor(v), (entry,), self.mesh)
                .to(self.mesh.device) for k, v in batch.items()}

    def seq_block(self, x):
        """This rank's block of the sequence of a (B_loc, S, d) activation."""
        n = x.shape[1] // self.model_size
        return x.narrow(1, self.mesh.index(("model",)) * n, n)

    def to_residual(self, x):
        """A (B_loc, S, d) activation the ``"model"`` ranks hold alike, as
        the residual layout."""
        return self.seq_block(x) if self.seq else x

    def gather_seq(self, x):
        """A residual-layout activation made (B_loc, S, d)."""
        from repro_torch.distributed import tensor_parallel as tp
        return tp.all_gather(x, self.mesh, ("model",), 1) if self.seq else x

    def enter_tp(self, h):
        """The input of a column-parallel product: the whole sequence."""
        return self.gather_seq(h)

    def leave_tp(self, y, w, w_dim: int):
        """The output of the product with ``w`` (contracting its dimension
        ``w_dim``) back in the residual layout: a row-parallel partial sum
        added over ``"model"`` in float32 and rounded once (reduce-scattered
        by sequence block in the sequence layout), else cut to the block."""
        from repro_torch.distributed import tensor_parallel as tp
        if not tp._tp(w, w_dim, self.mesh):
            return self.to_residual(y)
        y32 = y.to(torch.float32)
        if self.seq:
            return tp.reduce_scatter(y32, self.mesh, ("model",), 1).to(
                y.dtype)
        return tp.all_reduce(y32, self.mesh, ("model",)).to(y.dtype)
