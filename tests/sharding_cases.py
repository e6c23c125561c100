"""The port's sharding rules (``repro_torch.distributed.sharding``), decode
state placement (``distributed.steps.decode_state_specs``) and decode
geometry (``models.model.make_decode_ctx``) against the JAX package's, on
``jax.sharding.AbstractMesh`` shapes (1, 4), (2, 2), (4, 1), (2, 4) and
("pod", "data", "model") = (2, 2, 2), and on the production shapes: no
ranks, no devices.  Every arch of ``configs``, at its smoke and its
published size: the logical axes and shapes of every leaf equal JAX's, and
JAX's ``param_specs`` equals the port's on the (2, 2) mesh (JAX's runs an
``eval_shape`` of the whole init, a second or so an arch), and JAX's
``spec_for`` of JAX's own axes equals the port's ``param_specs`` on every
other mesh.  Specs compare as ``tuple(PartitionSpec)``.

Shared by the ``tests/test_torch_sharding_*.py`` files.
"""
import jax
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.launch import mesh as jmesh

from repro_torch.configs import get_config, smoke_config

MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def amesh(name):
    return AbstractMesh(*MESHES[name])


def shape_of(name) -> dict:
    sizes, axes = MESHES[name]
    return dict(zip(axes, sizes))


def flat_specs(tree) -> dict:
    """{"a/b/c": tuple(spec)} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(p.key for p in path): tuple(s) for path, s in leaves}


def flat_leaves(tree, is_leaf=None) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(p.key for p in path): v for path, v in leaves}


def configs(arch, size):
    if size == "smoke":
        return j_smoke_config(arch), smoke_config(arch)
    return j_get_config(arch), get_config(arch)


class FakeMesh:
    """The two attributes of a mesh that JAX's ``spec_for`` reads, for the
    production shapes (256 and 512 devices are not here)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def shape_of_jax(multi_pod):
    """The shape JAX's ``make_production_mesh`` asks ``jax.make_mesh``
    for."""
    seen = {}

    def fake(shape, axes):
        seen.update(zip(axes, shape))
    orig = jmesh._make_mesh_compat
    jmesh._make_mesh_compat = fake
    try:
        jmesh.make_production_mesh(multi_pod=multi_pod)
    finally:
        jmesh._make_mesh_compat = orig
    return seen
