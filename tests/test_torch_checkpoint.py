"""The port's checkpointer (``repro_torch.checkpoint``) keeps the JAX
package's on-disk format, so a checkpoint crosses in both directions: the
generic cases of ``tests/test_checkpoint.py`` on the port, a save that
snapshots a tree the caller then updates in place, a model and optimizer
state (a dense model; jamba's hybrid one of mamba, attention and MoE
layers in units of 4 under ``stacks/j0 .. j3``; whisper's under
``stacks/encoder`` and ``stacks/decoder``; xlstm's sLSTM and mLSTM units)
and three HashMem tables
(displaced with a stash, extendible after a split, two shards stacked)
saved by JAX and restored by the port with equal leaves and equal probes,
and the port's manifest, files and leaves read back by JAX.  Everything
here is exact: the files carry bits."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.base import HashMemConfig as JHashMemConfig
from repro.configs.base import OptimConfig as JOptimConfig
from repro.core import hashmap as jhashmap
from repro.core import rlu as jrlu
from repro.models import model as jmodel
from repro.optim import init_opt_state as j_init_opt_state

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import HashMemConfig, OptimConfig, smoke_config
from repro_torch.core import hashmap, rlu
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.train import _restore_tree_shapes
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree
from repro_torch.optim import init_opt_state

from model import mine_bucket_colliding_keys
from test_checkpoint import _displaced_cfg as _j_displaced_cfg

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and PyTorch's thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


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


# ---------------------------------------------------------------------------
# JAX saves, the port restores
# ---------------------------------------------------------------------------

def j_train_state(cfg, oc, seed=0):
    params = jmodel.init_params(cfg, jax.random.PRNGKey(seed))
    opt = j_init_opt_state(params, oc)
    # moments that are not zeros, so the restore is seen to carry them
    opt["m"] = jax.tree.map(lambda p: (p * 0.5).astype(opt_dtype(oc)), params)
    opt["v"] = jax.tree.map(lambda p: (p * p).astype(opt_dtype(oc)), params)
    opt["step"] = jnp.int32(17)
    return {"params": params, "opt": opt}


def opt_dtype(oc):
    return jnp.bfloat16 if oc.state_dtype == "bfloat16" else jnp.float32


def port_moments(pd) -> dict:
    """A ParamDict of moments as {JAX path: array}, layers stacked, bits of
    bfloat16 as uint16."""
    out = {}
    for path, (names, stacked) in model.jax_leaves(pd).items():
        ts = [pd[n] for n in names]
        ts = [t.view(torch.int16).numpy().view(np.uint16)
              if t.dtype == torch.bfloat16 else t.numpy() for t in ts]
        out[path] = np.stack(ts) if stacked else ts[0]
    return out


def j_moments(tree) -> dict:
    return flatten_tree(jax.tree.map(
        lambda x: np.asarray(x).view(np.uint16)
        if x.dtype == jnp.bfloat16 else np.asarray(x), tree))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_jax_train_state_restores_into_the_port(tmp_path, state_dtype):
    arch = "qwen3-8b"
    joc = JOptimConfig(state_dtype=state_dtype)
    from repro.configs import smoke_config as j_smoke_config
    jstate = j_train_state(j_smoke_config(arch), joc)
    JCheckpointer(str(tmp_path), async_save=False).save(3, jstate)

    cfg = smoke_config(arch)
    got = Checkpointer(str(tmp_path)).restore(
        3, _restore_tree_shapes(cfg, OptimConfig(state_dtype=state_dtype)),
        device=CPU)
    want = flatten_tree(jax.tree.map(np.asarray, jstate["params"]))
    have = flatten_tree(model.params_to_numpy(got["params"]))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], k)
    assert got["params"].embed.requires_grad
    for mom in ("m", "v"):
        w, h = j_moments(jstate["opt"][mom]), port_moments(got["opt"][mom])
        assert w.keys() == h.keys()
        for k in w:
            np.testing.assert_array_equal(h[k], w[k], f"{mom} {k}")
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 17


def port_table_leaves(hm) -> dict:
    return hashmap.to_numpy(hm)


def j_table_leaves(jhm) -> dict:
    st = jhm.store
    out = {"bucket_head": jhm.bucket_head}
    for f in ("pool", "planes", "page_next", "page_fill", "free_top",
              "fprints", "stash", "stash_fill", "local_depth"):
        if getattr(st, f) is not None:
            out[f] = getattr(st, f)
    return {k: np.asarray(v) for k, v in out.items()}


def assert_table_equal(hm, jhm):
    have, want = port_table_leaves(hm), j_table_leaves(jhm)
    assert have.keys() == want.keys()
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], k)


def port_cfg(jcfg) -> HashMemConfig:
    import dataclasses
    return HashMemConfig(**dataclasses.asdict(jcfg))


def test_jax_displaced_table_restores_into_the_port(tmp_path):
    jcfg = _j_displaced_cfg()
    keys = mine_bucket_colliding_keys(36, jcfg.num_buckets, same_b2=True)
    vals = np.arange(1, 37, dtype=np.uint32) * 5
    jhm, ok = jhashmap.insert(jhashmap.create(jcfg), jnp.asarray(keys),
                              jnp.asarray(vals))
    assert bool(np.asarray(ok).all())
    assert int(np.asarray(jhm.store.stash_fill)) > 0
    JCheckpointer(str(tmp_path), async_save=False).save(11, jhm)

    cfg = port_cfg(jcfg)
    hm = Checkpointer(str(tmp_path)).restore(
        11, hashmap.create(cfg, CPU), device=CPU)
    assert_table_equal(hm, jhm)
    qs = np.concatenate([keys, keys + 7_000_000]).astype(np.uint32)
    jv, jf = jhashmap.probe(jhm, jnp.asarray(qs))
    v, f = hashmap.probe(hm, qs)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert bool(f[:36].all())


def extendible_jax_table():
    jcfg = JHashMemConfig(num_buckets=8, slots_per_page=4, overflow_pages=120,
                          max_chain=2, backend="ref", auto_grow=True,
                          resize="extendible", max_load_factor=1.0)
    keys = mine_bucket_colliding_keys(20, jcfg.num_buckets, same_b2=False)
    events: dict = {}
    jhm, ok = jhashmap.insert_extendible(
        jhashmap.create(jcfg), jnp.asarray(keys),
        jnp.arange(1, 21, dtype=jnp.uint32), events=events)
    assert bool(np.asarray(ok).all()) and events.get("splits", 0) >= 1
    return jhm, keys


def test_jax_extendible_table_restores_into_the_port(tmp_path):
    jhm, keys = extendible_jax_table()
    JCheckpointer(str(tmp_path), async_save=False).save(4, jhm)
    # the directory width is config-derived: restore targets the grown cfg
    cfg = port_cfg(jhm.config)
    hm = Checkpointer(str(tmp_path)).restore(
        4, hashmap.create(cfg, CPU), device=CPU)
    assert_table_equal(hm, jhm)
    st = hashmap.stats(hm)
    assert st["max_local_depth"] > st["min_local_depth"]
    qs = np.concatenate([keys, keys + 5_000_000]).astype(np.uint32)
    jv, jf = jhashmap.probe(jhm, jnp.asarray(qs))
    v, f = hashmap.probe(hm, qs)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert bool(f[:20].all())


def test_jax_sharded_table_restores_as_a_stacked_port_table(tmp_path):
    """JAX restores a saved 2-shard table elastically onto a mesh; the port
    restores it as a stacked table (both shards on one device) whose
    ``probe_sharded`` answers each query as JAX's probe of its owner shard
    does, bit for bit."""
    jcfg = _j_displaced_cfg()
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 1 << 30, 64).astype(np.uint32))
    vals = (keys * 3 + 1).astype(np.uint32)
    jhm = jrlu.build_sharded(jcfg, jnp.asarray(keys), jnp.asarray(vals), 2,
                             shard_by="highbits")
    JCheckpointer(str(tmp_path), async_save=False).save(1, jhm)

    cfg = port_cfg(jcfg)
    target = hashmap.stack([hashmap.create(cfg, CPU) for _ in range(2)])
    hm = Checkpointer(str(tmp_path)).restore(1, target, device=CPU)
    assert_table_equal(hm, jhm)
    qs = np.concatenate([keys, keys + 9_000_000]).astype(np.uint32)
    qs = qs[:(qs.size // 2) * 2]
    v, f = rlu.probe_sharded(make_serving_mesh(2, device=CPU), hm, qs, cfg,
                             shard_by="highbits")
    owner = np.asarray(jrlu.owner_of(jnp.asarray(qs), jcfg, 2,
                                     shard_by="highbits"))
    for d in range(2):
        m = owner == d
        shard = jax.tree.map(lambda x: x[d], jhm)
        ev, ef = jhashmap.probe(shard, jnp.asarray(qs[m]))
        np.testing.assert_array_equal(v.numpy()[m],
                                      np.asarray(ev).astype(np.int64))
        np.testing.assert_array_equal(f.numpy()[m], np.asarray(ef))
    assert f[:keys.size].all() and not f[keys.size:].any()


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
    jcfg = _j_displaced_cfg()
    keys = mine_bucket_colliding_keys(36, jcfg.num_buckets, same_b2=True)
    jd, _ = jhashmap.insert(jhashmap.create(jcfg), jnp.asarray(keys),
                            jnp.arange(1, 37, dtype=jnp.uint32))
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
