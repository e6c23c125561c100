"""The serving meshes of the port (the JAX package's ``launch/mesh.py``
``make_serving_mesh``).

JAX lays a sharded table over a 1-D device mesh, one shard per device on
the channel ('model') axis.  The port has two forms of that mesh:

  * ``ServingMesh``: the D shards stacked on one device, each routed phase
    a local permutation (``core/rlu.py``);
  * ``RankMesh``: one shard a rank of a ``torch.distributed`` process
    group, each routed phase an ``all_to_all_single`` -- the body JAX runs
    inside ``shard_map`` for one device.  ``spawn_ranks`` starts such a
    world on one host.

The model meshes of ``make_mesh`` are ``ModelMesh``es: a world of ranks laid
out row-major over named axes (``("data", "model")`` or ``("pod", "data",
"model")``), one process group per axis subset, over which decode reduces
and gathers (``make_model_mesh``); a ``RecordingMesh`` is one rank of such
a mesh with no world, whose collectives count and move nothing (the
dry-run's, ``recording_mesh``).  The sharding rules and the decode
geometry also take a bare shape, {axis name: size}
(``make_production_mesh`` gives the production one), which builds no
world.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.core.layout import resolve_device

DIST_BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class ServingMesh:
    """``num_shards`` HashMem shards stacked on ``device`` along ``axis``."""

    num_shards: int
    axis: str
    device: torch.device

    @property
    def shape(self) -> dict:
        """{axis: num_shards}, as a JAX mesh's ``shape``."""
        return {self.axis: self.num_shards}


def make_serving_mesh(num_shards: int, axis: str = "model",
                      device=None) -> ServingMesh:
    """A mesh of ``num_shards`` shards on ``device`` (None: the card, which
    must be there; "cpu" runs the plain PyTorch versions)."""
    if num_shards < 1:
        raise ValueError(f"a serving mesh needs at least one shard, got "
                         f"{num_shards}")
    return ServingMesh(int(num_shards), axis, resolve_device(device))


@dataclass(frozen=True)
class RankMesh:
    """This process's place in a world of ``num_shards`` ranks, one shard a
    rank along ``axis``: its ``rank``, its ``device`` and the process
    ``group`` the routed phases exchange over.  ``exchanges`` counts the
    collectives of ``core/rlu.py`` on this rank: calls, bytes sent and
    host seconds inside them."""

    num_shards: int
    rank: int
    axis: str
    device: torch.device
    backend: str
    group: object = field(compare=False)
    exchanges: dict = field(default_factory=lambda: {
        "calls": 0, "bytes": 0, "seconds": 0.0}, compare=False)

    @property
    def shape(self) -> dict:
        """{axis: num_shards}, as a JAX mesh's ``shape``."""
        return {self.axis: self.num_shards}


def _rank_device(world_size: int, rank: int, backend: str, device):
    if device is not None:
        dev = resolve_device(device)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl exchanges CUDA tensors: a rank on "
                             f"{dev} needs gloo")
        n = torch.cuda.device_count()
        if world_size > n or dev.index != rank:
            raise ValueError(f"nccl needs one card a rank (rank {rank} on "
                             f"cuda:{rank}); {world_size} ranks, {n} "
                             f"card(s), this rank on {dev}: use gloo to "
                             f"share a card")
    return dev


def make_rank_mesh(world_size: int, rank: int, init_method: str, *,
                   backend: str, axis: str = "model", device=None,
                   timeout: Optional[float] = None) -> RankMesh:
    """Join the world of ``world_size`` ranks at ``init_method`` (a
    ``file://`` store or a ``tcp://host:port`` address) as ``rank`` and
    return its mesh.  ``device=None`` is the card ``cuda:{rank % cards}``
    and raises without one; "cpu" only when asked.  ``backend`` is "nccl"
    (one card a rank) or "gloo" (the CPU, or several ranks on one card:
    gloo stages CUDA tensors through the host); it is never chosen for
    the caller.  ``timeout`` (seconds) bounds every collective."""
    import torch.distributed as dist
    if backend not in DIST_BACKENDS:
        raise ValueError(f"backend must be one of {DIST_BACKENDS}, got "
                         f"{backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    dev = _rank_device(world_size, rank, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)          # before anything touches CUDA
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return RankMesh(int(world_size), int(rank), axis, dev, backend,
                    dist.group.WORLD)


def sub_mesh(mesh: RankMesh, num_shards: int) -> Optional[RankMesh]:
    """The first ``num_shards`` ranks of ``mesh``'s world as a mesh of their
    own (a new process group).  Every rank of the world must call it, in
    the same order; a rank outside the new mesh gets None."""
    import torch.distributed as dist
    if not 1 <= num_shards <= mesh.num_shards:
        raise ValueError(f"a mesh of {num_shards} shards in a world of "
                         f"{mesh.num_shards}")
    group = dist.new_group(list(range(num_shards)))
    if mesh.rank >= num_shards:
        return None
    return RankMesh(int(num_shards), mesh.rank, mesh.axis, mesh.device,
                    mesh.backend, group)


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The shape of JAX's production mesh, {axis: size}: ``(16, 16)``
    ``("data", "model")``, or ``(2, 16, 16)`` with a ``"pod"`` axis.  A
    shape for the sharding rules and the decode geometry; it builds no
    world."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


COLLECTIVE_KINDS = ("all_gather", "reduce_scatter", "all_reduce",
                    "all_to_all")
# How ``ModelMesh.all_gather`` runs on each backend: gloo's list
# ``all_gather`` takes 1.6-3x as long as an ``all_to_all_single`` of n
# copies of the tensor at 1-64 MB a rank (4 ranks on one H100,
# ``tools/collective_bench.py --kinds``), so gloo gathers by all-to-all
ALL_GATHER_FORM = {"gloo": "all_to_all", "nccl": "all_gather"}


def _new_collectives() -> dict:
    return {"calls": 0, "bytes": 0, "seconds": 0.0, "by_kind": {}}


def _pass_of(backward: bool) -> str:
    """"backward" inside a collective's own backward; "recompute" for a
    forward collective that the autograd engine runs (a remat'ed unit
    recomputed in the backward pass); else "forward"."""
    if backward:
        return "backward"
    return "recompute" if torch._C._current_graph_task_id() != -1 \
        else "forward"


@dataclass(frozen=True)
class ModelMesh:
    """This rank's place in a mesh of ranks over named axes: ``shape``, an
    ordered {axis: size} whose product is the world size; ``coords``, this
    rank's {axis: index}, numbered row-major as JAX numbers a mesh's
    devices (the last axis fastest); ``groups``, a process group for every
    subset of the axes that spans more than one rank (the ranks that share
    the other axes' coordinates, in row-major order).  A collective over
    axes of size 1 is skipped.  ``collectives`` counts this rank's calls,
    bytes sent and host seconds inside them, in all and under ``by_kind``
    by "{kind}/{pass}" (``COLLECTIVE_KINDS``; the pass is "forward",
    "recompute" or "backward"), where each kind also keeps the bytes of its
    largest call (``largest``).  A mesh is a handle on the world: a copy
    of it is itself."""

    shape: dict
    rank: int
    coords: dict
    device: torch.device
    backend: str
    groups: dict = field(compare=False)
    collectives: dict = field(default_factory=_new_collectives,
                              compare=False)

    def __deepcopy__(self, memo):
        return self

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def num_shards(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axes) -> int:
        """The number of ranks along ``axes``."""
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index along ``axes`` (in the order given:
        JAX's flat index over them)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def _group(self, axes):
        return self.groups[tuple(a for a in self.shape if a in axes)]

    def _count(self, t: torch.Tensor, dt: float, kind: str, backward: bool):
        nbytes = t.numel() * t.element_size()
        st = self.collectives
        st["calls"] += 1
        st["bytes"] += nbytes
        st["seconds"] += dt
        k = st["by_kind"].setdefault(f"{kind}/{_pass_of(backward)}",
                                     {"calls": 0, "bytes": 0, "seconds": 0.0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["seconds"] += dt
        k["largest"] = max(k.get("largest", 0), nbytes)

    def _collective(self, kind: str, x: torch.Tensor, out: torch.Tensor,
                    axes, backward: bool, op: str = "sum") -> torch.Tensor:
        """One collective of ``x`` over ``axes`` into ``out``
        (``_transport``), counted as ``x``'s bytes sent."""
        out, dt = self._transport(kind, x, out, axes, op)
        self._count(x, dt, kind, backward)
        return out

    def _transport(self, kind: str, x: torch.Tensor, out: torch.Tensor,
                   axes, op: str):
        """Move the data of one collective over the process group of
        ``axes``: (its result, the host seconds it took).  An all-reduce
        sums ``x`` in place; an all-gather fills ``out`` (n, ...) with the
        ranks' ``x`` in their row-major order (in ``ALL_GATHER_FORM``'s
        form for the backend); a reduce-scatter and an all-to-all fill
        ``out``."""
        import torch.distributed as dist
        group = self._group(axes)
        t0 = time.perf_counter()
        with record_function(f"mesh.{kind}"):
            if kind == "all_reduce":
                red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
                dist.all_reduce(x, op=red, group=group)
                out = x
            elif kind == "all_gather" and \
                    ALL_GATHER_FORM[self.backend] == "all_gather":
                dist.all_gather(list(out.unbind(0)), x, group=group)
            elif kind == "all_gather":
                dist.all_to_all_single(out, x.expand(out.shape).contiguous(),
                                       group=group)
            elif kind == "reduce_scatter":
                # the same collective under the name of the torch at hand
                rs = getattr(dist, "reduce_scatter_single",
                             dist.reduce_scatter_tensor)
                rs(out, x, group=group)
            else:
                dist.all_to_all_single(out, x, group=group)
        return out, time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum",
                   backward: bool = False):
        """``t`` summed (``op="max"``: its largest) over the ranks along
        ``axes``; in place when a collective runs."""
        if self.size(axes) == 1:
            return t
        t = t.contiguous()
        return self._collective("all_reduce", t, t, axes, backward, op)

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0,
                   backward: bool = False):
        """The ranks' ``t`` along ``axes`` joined on ``dim`` in their
        row-major order."""
        n = self.size(axes)
        if n == 1:
            return t
        t = t.contiguous()
        out = self._collective("all_gather", t, t.new_empty((n,) + t.shape),
                               axes, backward)
        return torch.cat(out.unbind(0), dim=dim)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0,
                       backward: bool = False):
        """``t`` summed over the ranks along ``axes``, and of the sum this
        rank's block along ``dim`` (cut into equal blocks in their
        row-major order): the conjugate of ``all_gather``.  gloo runs it on
        CUDA tensors too (staged through the host)."""
        n = self.size(axes)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter of {t.shape[dim]} rows over "
                             f"{n} ranks")
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        return self._collective("reduce_scatter", x, out, axes,
                                backward).movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, axes, backward: bool = False):
        """``t`` (n, ...) over the n ranks along ``axes``: block j goes to
        the j-th rank, and block j of the result is what the j-th rank sent
        here (``jax.lax.all_to_all`` on dimension 0, untiled)."""
        n = self.size(axes)
        if n == 1:
            return t
        if t.shape[0] != n:
            raise ValueError(f"all_to_all of {t.shape[0]} blocks over {n} "
                             f"ranks")
        t = t.contiguous()
        return self._collective("all_to_all", t, torch.empty_like(t), axes,
                                backward)


def mesh_coords(shape: dict, rank: int) -> dict:
    """Rank ``rank``'s {axis: index} on a mesh of ``shape``, row-major (the
    last axis fastest)."""
    coords = {}
    for a in reversed(tuple(shape)):
        coords[a] = rank % shape[a]
        rank //= shape[a]
    return {a: coords[a] for a in shape}


@dataclass(frozen=True)
class RecordingMesh(ModelMesh):
    """A ``ModelMesh`` with no world: rank ``rank`` of a mesh of ``shape``
    (``recording_mesh``), which any number of ranks can take, as the
    dry-run's production meshes of 256 and 512 ranks.  Its collectives
    are the real mesh's (the skip over axes of size 1, the shapes and
    checks, the count of ``_collective``) but for ``_transport``, which
    moves nothing and takes no seconds: each returns a tensor of the
    shape the real one returns, holding no data, and its ``collectives``
    are a real mesh's, call for call and byte for byte, by kind and pass.
    ``results`` keeps, by kind, the calls and the bytes of their results
    (what an HLO collective's shape says; ``dryrun.jax_collectives``).
    It imports nothing of ``torch.distributed``."""

    results: dict = field(default_factory=dict, compare=False)

    def _transport(self, kind: str, x, out, axes, op: str):
        r = self.results.setdefault(kind, {"calls": 0, "bytes": 0})
        r["calls"] += 1
        r["bytes"] += out.numel() * out.element_size()
        return out, 0.0

    def reset(self):
        """Count from zero."""
        self.collectives.clear()
        self.collectives.update(_new_collectives())
        self.results.clear()


def recording_mesh(shape: dict, rank: int = 0) -> RecordingMesh:
    """Rank ``rank`` of a mesh of ``shape``, {axis: size} in mesh order,
    on the CPU, with no world (``RecordingMesh``)."""
    shape = {a: int(n) for a, n in shape.items()}
    if not 0 <= rank < math.prod(shape.values()):
        raise ValueError(f"rank {rank} is outside a mesh of {shape}")
    return RecordingMesh(shape, rank, mesh_coords(shape, rank),
                         torch.device("cpu"), "recording", {})


def make_model_mesh(world: RankMesh, shape: dict) -> ModelMesh:
    """Lay the ranks of ``world`` (the whole world, ``spawn_ranks``'s mesh)
    out over ``shape``, {axis: size} in mesh order, and make the process
    groups of every axis subset.  Every rank must call it, with the same
    shape (every rank makes every group, in the same order)."""
    import torch.distributed as dist
    shape = {a: int(n) for a, n in shape.items()}
    world_size = math.prod(shape.values())
    if world_size != world.num_shards or \
            world.num_shards != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs a world of {world_size} "
                         f"ranks; this one has {world.num_shards} of "
                         f"{dist.get_world_size()}")
    names = tuple(shape)
    coords = mesh_coords(shape, world.rank)
    strides = {a: math.prod(shape[b] for b in names[i + 1:])
               for i, a in enumerate(names)}
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if math.prod(shape[a] for a in axes) == 1:
                continue
            if len(axes) == len(names):
                groups[axes] = world.group
                continue
            rest = [a for a in names if a not in axes]
            for fixed in itertools.product(*(range(shape[a]) for a in rest)):
                base = sum(strides[a] * i for a, i in zip(rest, fixed))
                ranks = sorted(
                    base + sum(strides[a] * i for a, i in zip(axes, idx))
                    for idx in itertools.product(
                        *(range(shape[a]) for a in axes)))
                g = dist.new_group(ranks)
                if world.rank in ranks:
                    groups[axes] = g
    return ModelMesh(shape, world.rank, coords, world.device, world.backend,
                     groups)


def _rank_main(rank, world_size, init_method, backend, device, axis,
               timeout, out_dir):
    import torch.distributed as dist
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)            # ranks on the CPU share it
    mesh = make_rank_mesh(world_size, rank, init_method, backend=backend,
                          axis=axis, device=device, timeout=timeout)
    try:
        out = fn(mesh, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn, world_size: int, *args, backend: str = "gloo",
                device=None, axis: str = "model",
                timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` new processes, one a rank,
    and return their results in rank order.  The processes start by the
    ``spawn`` method (CUDA cannot follow a fork) and meet at a file store in
    a new temporary directory, so concurrent worlds never compete for a
    port.  ``fn`` and ``args`` must pickle (``fn`` at the top level of an
    importable module); they reach the ranks through a file in that
    directory, not the start-up pipe, whose 64 kB buffer would hold back
    each start until the rank before has imported its modules.  A rank
    that raises stops the others and makes this call raise."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        mp.start_processes(
            _rank_main, args=(world_size, init, backend, device, axis,
                              timeout, tmp),
            nprocs=world_size, join=True, start_method="spawn")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
