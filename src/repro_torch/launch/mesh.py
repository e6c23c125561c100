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

The model meshes of ``make_mesh`` are not ported: the training and decode
steps take a mesh as its shape, {axis name: size}, and refuse more than one
shard (ROADMAP Queue 1 item 16b).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from dataclasses import dataclass, field
from typing import Optional

import torch

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


def _rank_main(rank, fn, world_size, init_method, backend, device, axis,
               timeout, out_dir, args):
    import torch.distributed as dist
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
    importable module).  A rank that raises stops the others and makes
    this call raise."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.start_processes(
            _rank_main, args=(fn, world_size, init, backend, device, axis,
                              timeout, tmp, args),
            nprocs=world_size, join=True, start_method="spawn")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
