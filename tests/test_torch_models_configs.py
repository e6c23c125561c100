"""Parity of the port's model zoo with the JAX package's: the configs copied
verbatim, and the shapes and parameter count. The tolerances are in
``tests/models_cases.py``."""
import dataclasses

import pytest

from repro.configs import smoke_config as j_smoke_config
from repro.models import model as jmodel

from repro_torch.configs import SHAPES, get_config, smoke_config

import torch_threads
import models_cases
from models_cases import DENSE

no_grad = models_cases.no_grad

one_thread = torch_threads.one_thread


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-8b", "phi4-mini-3.8b",
                                  "h2o-danube-1.8b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "xlstm-1.3b",
                                  "whisper-tiny", "internvl2-2b",
                                  "llama4-maverick-400b-a17b"])
def test_configs_copied_verbatim(arch):
    from repro.configs import get_config as j_get_config
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(j_smoke_config(arch))
    assert get_config(arch).padded_vocab == j_get_config(arch).padded_vocab


def test_shapes_and_param_count():
    from repro.configs.base import SHAPES as J_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for arch in DENSE:
        cfg = smoke_config(arch)
        assert cfg.param_count() == jmodel.count_params(j_smoke_config(arch))
    # Qwen3-8B at its published widths (vocabulary padded to 152064), from
    # shapes alone on both sides
    from repro.configs import get_config as j_get_config
    assert get_config("qwen3-8b").param_count() == \
        jmodel.count_params(j_get_config("qwen3-8b")) == 8_191_783_936
