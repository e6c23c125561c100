"""The port's checkpointer (``repro_torch.checkpoint``) on the generic cases of
``tests/test_checkpoint.py``, and a save that snapshots a tree the caller
then updates in place. Everything here is exact: the files carry bits."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import OptimConfig, smoke_config
from repro_torch.launch.train import _restore_tree_shapes
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree
from repro_torch.optim import init_opt_state

import torch_threads
import checkpoint_cases
from checkpoint_cases import CPU, tree

jitted_jax_tables = checkpoint_cases.jitted_jax_tables

one_thread = torch_threads.one_thread


def meta_tree():
    return {"a": torch.empty((16, 8), device="meta"),
            "b": {"c": torch.empty(10, dtype=torch.int32, device="meta"),
                  "d": torch.empty((), device="meta")}}


def flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k].cpu(), fb[k].cpu()), k


# ---------------------------------------------------------------------------
# The generic cases of tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------
def test_roundtrip_bitexact(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(7, tree())
    assert ck.latest_step() == 7
    assert_trees_equal(ck.restore(7, meta_tree(), device=CPU), tree())


def test_async_save_then_restore(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, tree(1))
    ck.wait()
    assert_trees_equal(ck.restore(1, meta_tree(), device=CPU), tree(1))


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, tree())
    d = tmp_path / "step_00000003"
    manifest = json.loads((d / "manifest.json").read_text())
    name = next(k for k, v in manifest["arrays"].items()
                if v["shape"] == [16, 8])
    fn = manifest["arrays"][name]["file"]
    arr = np.load(d / fn)
    arr[0, 0] += 1
    np.save(d / fn, arr)
    with pytest.raises(IOError, match="corruption"):
        ck.restore(3, meta_tree(), device=CPU)


def test_gc_keeps_last_three(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    for s in range(5):
        ck.save(s, {"x": torch.zeros(3)})
    assert sorted(ck.all_steps()) == [2, 3, 4]


def test_atomicity_no_partial_dir(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, tree())
    assert not list(tmp_path.glob("tmp.*"))


def test_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, tree())
    bad = meta_tree()
    bad["a"] = torch.empty((8, 16), device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(1, bad, device=CPU)


# ---------------------------------------------------------------------------
# Save snapshots: the caller's in-place updates after save() never reach
# the files
# ---------------------------------------------------------------------------
def test_async_save_snapshots_before_in_place_updates(tmp_path):
    cfg = smoke_config("llama3-8b").replace(dtype="float32")
    oc = OptimConfig(state_dtype="bfloat16")
    params = model.init_params(cfg, 0, CPU)
    opt = init_opt_state(params, oc)
    before = {"params": model.params_to_numpy(params),
              "m": {n: t.clone() for n, t in opt["m"].items()}}
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(5, {"params": params, "opt": opt})
    with torch.no_grad():              # what the next optimizer step does
        for p in params.parameters():
            p.add_(1.0)
        for t in opt["m"].values():
            t.add_(1.0)
    ck.wait()
    got = ck.restore(5, _restore_tree_shapes(cfg, oc), device=CPU)
    want, have = (flatten_tree(before["params"]),
                  flatten_tree(model.params_to_numpy(got["params"])))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], k)
    for n, t in before["m"].items():
        assert got["opt"]["m"][n].dtype == torch.bfloat16
        assert torch.equal(got["opt"]["m"][n], t), n
