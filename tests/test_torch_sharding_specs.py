"""The port's ``spec_for``, mesh axes and batch specs against the JAX package's
on ``jax.sharding.AbstractMesh`` shapes (1, 4), (2, 2), (4, 1), (2, 4) and
("pod", "data", "model") = (2, 2, 2): no ranks, no devices."""
import numpy as np
import pytest

from repro.distributed import sharding as jsh

from repro_torch.distributed import sharding

import torch_threads
from sharding_cases import MESHES, amesh, shape_of

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_and_mesh_axes_match_jax(mesh):
    """Random logical axes and shapes, divisible or not, on each mesh."""
    rng = np.random.default_rng(len(mesh))
    names = list(sharding.RULES) + ["unknown"]
    am = amesh(mesh)
    for name in names:
        assert sharding.mesh_axes_for(shape_of(mesh), name) == \
            jsh.mesh_axes_for(am, name)
    for _ in range(300):
        n = int(rng.integers(1, 5))
        axes = tuple(rng.choice(names, n))
        shape = tuple(int(x) for x in rng.choice([1, 2, 3, 4, 6, 8, 16, 24],
                                                 n))
        assert sharding.spec_for(shape_of(mesh), axes, shape) == \
            tuple(jsh.spec_for(am, jax_axes(axes), shape)), (axes, shape)


def jax_axes(axes):
    from repro.models.layers import Axes
    return Axes(tuple(axes))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_and_batch_specs_match_jax(mesh):
    am = amesh(mesh)
    for B in (1, 2, 3, 4, 6, 8, 16):
        got = sharding.batch_spec(shape_of(mesh), B)
        assert got == jsh.batch_spec(am, B), B
        batch = {"tokens": np.zeros((B, 8), np.int32),
                 "labels": np.zeros((B, 8), np.int32),
                 "patch_embeds": np.zeros((B, 4, 16), np.float32)}
        want = {k: tuple(v) for k, v in
                jsh.batch_specs(None, am, batch).items()}
        assert sharding.batch_specs(None, shape_of(mesh), batch) == want
