"""The port's parameter axes, shapes and specs against the JAX package's, every
arch of ``configs`` at its smoke size (``tests/sharding_cases.py``)."""
import pytest

from repro.distributed import sharding as jsh
from repro.models import model as jmodel

from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model

import torch_threads
from sharding_cases import (
    FakeMesh, MESHES, amesh, configs, flat_leaves, flat_specs, shape_of,
    shape_of_jax)

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("size", ["smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_shapes_and_specs_match_jax(arch, size):
    jcfg, cfg = configs(arch, size)
    want_axes = flat_leaves(jmodel.param_axes(jcfg),
                            is_leaf=lambda x: isinstance(x, tuple))
    assert model.param_axes(cfg) == {k: tuple(v)
                                     for k, v in want_axes.items()}
    jspecs = flat_specs(jsh.param_specs(jcfg, amesh("2x2")))
    shapes = model.param_shapes(cfg)
    assert set(shapes) == set(want_axes) == set(jspecs)
    assert sharding.param_specs(cfg, shape_of("2x2")) == jspecs
    for name in MESHES:
        am = amesh(name)
        want = {k: tuple(jsh.spec_for(am, a, shapes[k]))
                for k, a in want_axes.items()}
        assert sharding.param_specs(cfg, shape_of(name)) == want, name
    for multi_pod in (False, True):
        prod = make_production_mesh(multi_pod=multi_pod)
        assert prod == shape_of_jax(multi_pod)
        got = sharding.param_specs(cfg, prod)
        assert got == {k: tuple(jsh.spec_for(FakeMesh(prod), a, shapes[k]))
                       for k, a in want_axes.items()}
