"""The port's checkpointer keeps the JAX package's on-disk format: the port's
manifest, files and leaves read back by JAX, for a dense model and optimizer
state, jamba's hybrid one (mamba, attention and MoE layers in units of 4
under ``stacks/j0 .. j3``), whisper's (``stacks/encoder`` and
``stacks/decoder``), xlstm's sLSTM and mLSTM units, and HashMem tables.
Exact."""
import json

import jax
import numpy as np
import pytest

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.base import OptimConfig as JOptimConfig
from repro.core import hashmap as jhashmap

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import OptimConfig, smoke_config
from repro_torch.core import hashmap
from repro_torch.launch.train import _restore_tree_shapes
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree

import torch_threads
import checkpoint_cases
from checkpoint_cases import (
    CPU, displaced_jax_table, extendible_jax_table, j_moments,
    j_table_leaves, j_train_state, port_cfg, port_moments)

jitted_jax_tables = checkpoint_cases.jitted_jax_tables

one_thread = torch_threads.one_thread


# ---------------------------------------------------------------------------
# The port saves, JAX restores
# ---------------------------------------------------------------------------
def manifest(d):
    return json.loads((d / "manifest.json").read_text())


def assert_same_checkpoint(port_dir, jax_dir):
    """Equal manifests (names, files, shapes, dtypes, sha256, in the same
    order) and byte-equal .npy files."""
    pm, jm = manifest(port_dir), manifest(jax_dir)
    assert list(pm["arrays"]) == list(jm["arrays"])
    assert pm == jm
    for meta in jm["arrays"].values():
        assert (port_dir / meta["file"]).read_bytes() == \
            (jax_dir / meta["file"]).read_bytes(), meta["file"]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_port_train_state_checkpoint_is_jax_s(tmp_path, state_dtype):
    from repro.configs import smoke_config as j_smoke_config
    joc = JOptimConfig(state_dtype=state_dtype)
    jstate = j_train_state(j_smoke_config("llama3-8b"), joc)
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(2, jstate)
    # the same tree in the port, through the port's restore
    state = Checkpointer(str(tmp_path / "j")).restore(
        2, _restore_tree_shapes(smoke_config("llama3-8b"),
                                OptimConfig(state_dtype=state_dtype)),
        device=CPU)
    Checkpointer(str(tmp_path / "p"), async_save=False).save(2, state)
    assert_same_checkpoint(tmp_path / "p" / "step_00000002",
                           tmp_path / "j" / "step_00000002")
    if state_dtype == "float32":
        # JAX's restore reads the port's files (it cannot place a bfloat16
        # leaf, which numpy loads as void bytes, on a device at all)
        target = jax.eval_shape(lambda: jstate)
        back = JCheckpointer(str(tmp_path / "p")).restore(2, target)
        for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_jamba_train_state_crosses_both_ways(tmp_path):
    """A JAX jamba train state (two units of 4 layers) restores into the
    port with equal parameters and moments; the port saves it back into the
    same files, byte for byte, and JAX's restore reads them."""
    from repro.configs import smoke_config as j_smoke_config
    jcfg = j_smoke_config("jamba-v0.1-52b").replace(num_layers=8)
    cfg = smoke_config("jamba-v0.1-52b").replace(num_layers=8)
    want = crosses_both_ways(tmp_path, jcfg, cfg, 5)
    assert {k.split("/")[1] for k in want if k.startswith("stacks")} == \
        {"j0", "j1", "j2", "j3"}


@pytest.mark.parametrize("arch", ["whisper-tiny", "xlstm-1.3b"])
def test_encdec_and_xlstm_train_states_cross_both_ways(tmp_path, arch):
    """The same for a whisper train state (``stacks/encoder`` and
    ``stacks/decoder``, the centred ``final_norm``) and an xlstm one (two
    units of sLSTM + mLSTM, no FFN leaves)."""
    from repro.configs import smoke_config as j_smoke_config
    want = crosses_both_ways(tmp_path, j_smoke_config(arch),
                             smoke_config(arch), 3)
    stacks = {k.split("/")[1] for k in want if k.startswith("stacks")}
    assert stacks == ({"encoder", "decoder"} if arch == "whisper-tiny"
                      else {"j0", "j1"})


def crosses_both_ways(tmp_path, jcfg, cfg, step) -> dict:
    """JAX saves a train state of ``jcfg``; the port restores it with equal
    parameters and moments and saves it back into the same files, byte for
    byte; JAX's restore reads them.  Returns the flat JAX parameters."""
    joc, oc = JOptimConfig(), OptimConfig()
    jstate = j_train_state(jcfg, joc)
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(step, jstate)
    state = Checkpointer(str(tmp_path / "j")).restore(
        step, _restore_tree_shapes(cfg, oc), device=CPU)
    want = flatten_tree(jax.tree.map(np.asarray, jstate["params"]))
    have = flatten_tree(model.params_to_numpy(state["params"]))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], k)
    for mom in ("m", "v"):
        w, h = j_moments(jstate["opt"][mom]), port_moments(state["opt"][mom])
        assert w.keys() == h.keys()
        for k in w:
            np.testing.assert_array_equal(h[k], w[k], f"{mom} {k}")
    Checkpointer(str(tmp_path / "p"), async_save=False).save(step, state)
    assert_same_checkpoint(tmp_path / "p" / f"step_{step:08d}",
                           tmp_path / "j" / f"step_{step:08d}")
    back = JCheckpointer(str(tmp_path / "p")).restore(
        step, jax.eval_shape(lambda: jstate))
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    return want


def test_port_tables_checkpoint_is_jax_s(tmp_path):
    jhm, _ = extendible_jax_table()
    jcfg, _, jd = displaced_jax_table(1)
    jtables = {"displaced": jd, "extendible": jhm}
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(6, jtables)
    tables = {"displaced": hashmap.from_numpy(port_cfg(jcfg),
                                              j_table_leaves(jd), CPU),
              "extendible": hashmap.from_numpy(port_cfg(jhm.config),
                                               j_table_leaves(jhm), CPU)}
    Checkpointer(str(tmp_path / "p"), async_save=False).save(6, tables)
    assert_same_checkpoint(tmp_path / "p" / "step_00000006",
                           tmp_path / "j" / "step_00000006")
    back = JCheckpointer(str(tmp_path / "p")).restore(6, {
        "displaced": jhashmap.create(jcfg),
        "extendible": jhashmap.create(jhm.config)})
    for name, jt in jtables.items():
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_flatten_with_path(jt)[0],
                jax.tree_util.tree_flatten_with_path(back[name])[0]):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
