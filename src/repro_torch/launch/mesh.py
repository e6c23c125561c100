"""The serving mesh of the port (the JAX package's ``launch/mesh.py``
``make_serving_mesh``).

JAX lays a sharded table over a 1-D device mesh, one shard per device on
the channel ('model') axis.  The port runs on one card: its mesh is the
number of shards stacked on that card, the axis name, and the card.  The
model meshes of ``make_mesh`` are not ported: the training and decode steps
take a mesh as its shape, {axis name: size}, and refuse more than one
shard (ROADMAP Queue 1 item 16).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.layout import resolve_device


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
