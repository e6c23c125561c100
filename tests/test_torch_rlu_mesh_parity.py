"""Parity of the port's routed phases (``rlu.probe_sharded``,
``delete_sharded``, ``insert_mesh``, ``tick_mesh``) with the JAX package's
on a real JAX mesh.  The JAX side needs four devices, so ONE subprocess
(``--xla_force_host_platform_device_count=4``, as
``tests/test_serving_sharded.py`` runs) calls it on a few small stacked
tables and writes every output and stacked leaf to an ``.npz``; the port,
on the CPU in this process, must equal it bit for bit.

Tables: a chained ``ref`` table and a chained ``perf`` table (``highbits``),
a displaced one (``mod``), a ``perf`` table whose build overflowed its arena
so that chains link past each shard's pool, the ``ref`` table with a chain
that links past shard 0's pool to a key that only the clamped read finds
(a page id must be clamped to its own shard before the shard's offset is
added, or the read lands in shard 1), and a batch whose keys all route to
one shard (the ``routing_cap`` case).  Caps: the worst case (None) and the
measured need."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import rlu as trlu
from repro_torch.launch.mesh import make_serving_mesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
D = 4

CASES = {
    "ref": (dict(num_buckets=16, slots_per_page=64, overflow_pages=64,
                 max_chain=4, backend="ref"), "highbits", 160),
    "perf": (dict(num_buckets=16, slots_per_page=64, overflow_pages=64,
                  max_chain=4, backend="perf"), "highbits", 160),
    "displaced": (dict(num_buckets=8, slots_per_page=32, overflow_pages=16,
                       max_chain=3, backend="ref", displacement=True,
                       fingerprint_bits=8, stash_slots=16), "mod", 160),
    "overflowed": (dict(num_buckets=4, slots_per_page=8, overflow_pages=2,
                        max_chain=6, backend="perf"), "mod", 64),
    "one_shard": (dict(num_buckets=16, slots_per_page=32, overflow_pages=32,
                       max_chain=4, backend="ref"), "highbits", 160),
    "past_pool": (dict(num_buckets=16, slots_per_page=64, overflow_pages=64,
                       max_chain=4, backend="ref"), "highbits", 160),
}


def past_pool(leaves: dict, cfg, shard_by, pq, dq):
    """Shard 0 links bucket b's chain past its pool (page P + 1) and holds
    a new key F on its last page P - 1, which JAX's clamped read finds;
    shard 1 holds F with another value on page 1, where an unclamped
    offset would read.  F is probed and deleted (JAX drops the tombstone
    write to page P + 1, so F stays)."""
    P = cfg.num_pages
    cand = np.arange(1, 100_000, dtype=np.uint32)
    owner, local = trlu.owner_and_local_bucket(cand, cfg, D, shard_by)
    pn = leaves["page_next"].copy()
    ok = (owner.numpy() == 0) & (pn[0][local.numpy()] == -1)
    F, b = int(cand[ok][0]), int(local[ok][0])
    pool = leaves["pool"].copy()
    assert (pool[0, P - 1, :, 0] == 0xFFFFFFFF).all() and pn[0, P - 1] == -1
    pn[0, b] = P + 1
    pool[0, P - 1, 0] = (F, 111)
    pool[1, 1, pool[1, 1, :, 0].argmax()] = (F, 222)   # an empty slot
    pq, dq = pq.copy(), dq.copy()
    pq[-1] = dq[-4] = F
    return dict(leaves, pool=pool, page_next=pn), pq, dq


def case_inputs(name):
    """Keys, values and the phase batches of one case (numpy, seeded)."""
    kw, shard_by, n = CASES[name]
    cfg = HashMemConfig(**kw)
    rng = np.random.default_rng(len(name))
    if name == "one_shard":
        cand = np.arange(1, 400_000, dtype=np.uint32)
        cand = cand[trlu.owner_of_np(cand, cfg, D, shard_by) == 0]
        keys = rng.choice(cand, n + 64, replace=False).astype(np.uint32)
    else:
        keys = rng.choice(2**31, n + 64, replace=False).astype(np.uint32)
    built, fresh = keys[:n], keys[n:]
    vals = rng.integers(1, 2**31, n).astype(np.uint32)
    probe_q = np.concatenate([built[:40], fresh[:20], built[:4]])  # 64
    del_q = np.concatenate([built[::3][:22], built[:2], fresh[:8]])  # 32
    del_q[-3:] = trlu.ROUTE_PAD                          # routing pads
    ins_k = np.concatenate([fresh[20:44], built[1:4], fresh[20:23], fresh[:2]])
    ins_v = rng.integers(1, 2**31, ins_k.size).astype(np.uint32)  # 32
    return cfg, shard_by, built, vals, probe_q, del_q, ins_k, ins_v


JAX_SIDE = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import HashMemConfig
from repro.core import rlu
from repro.launch.mesh import make_serving_mesh
sys.path.insert(0, {tests!r})
from test_torch_rlu_mesh_parity import CASES, D, case_inputs, past_pool

def leaves(hm, pre, out):
    out[pre + "pool"] = np.asarray(hm.store.pool)
    for n in ("page_next", "page_fill", "free_top"):
        out[pre + n] = np.asarray(getattr(hm.store, n))
    out[pre + "bucket_head"] = np.asarray(hm.bucket_head)
    for n in ("planes", "fprints", "stash", "stash_fill", "local_depth"):
        if getattr(hm.store, n) is not None:
            out[pre + n] = np.asarray(getattr(hm.store, n))

mesh = make_serving_mesh(D)
out = {{}}
for name in CASES:
    tcfg, sb, keys, vals, pq, dq, ik, iv = case_inputs(name)
    cfg = HashMemConfig(**dataclasses.asdict(tcfg))
    j = lambda a: jnp.asarray(a)
    hs = rlu.build_sharded(cfg, j(keys), j(vals), D, sb)
    leaves(hs, name + "/build/", out)
    if name == "past_pool":
        lv = {{k[len(name) + 7:]: v for k, v in out.items()
              if k.startswith(name + "/build/")}}
        lv, pq, dq = past_pool(lv, tcfg, sb, pq, dq)
        hs = dataclasses.replace(hs, store=dataclasses.replace(
            hs.store, pool=j(lv["pool"]), page_next=j(lv["page_next"])))
    caps = [rlu.routing_cap(q, cfg, D, sb) for q in (pq, dq, ik)]
    out[name + "/caps"] = np.asarray(caps)
    with mesh:
        for cap in (None, caps[0]):
            v, f = rlu.probe_sharded(mesh, hs, j(pq), cfg, cap=cap,
                                     shard_by=sb)
            out[f"{{name}}/probe{{cap}}/v"] = np.asarray(v)
            out[f"{{name}}/probe{{cap}}/f"] = np.asarray(f)
        hs2, df = rlu.delete_sharded(mesh, hs, j(dq), cfg, shard_by=sb)
        out[name + "/delete_found"] = np.asarray(df)
        leaves(hs2, name + "/delete/", out)
        hs3, ok = rlu.insert_mesh(mesh, hs2, j(ik), j(iv), cfg,
                                  cap=caps[2], shard_by=sb)
        out[name + "/insert_ok"] = np.asarray(ok)
        leaves(hs3, name + "/insert/", out)
        hs4, v, f, df, ok = rlu.tick_mesh(mesh, hs, j(pq), j(dq), j(ik),
                                          j(iv), cfg, caps=tuple(caps),
                                          shard_by=sb)
        for k, a in (("v", v), ("f", f), ("df", df), ("ok", ok)):
            out[f"{{name}}/tick_{{k}}"] = np.asarray(a)
        leaves(hs4, name + "/tick/", out)
np.savez({path!r}, **out)
print("JAX OK")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "jax.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={D}"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    code = JAX_SIDE.format(tests=os.path.join(ROOT, "tests"), path=path)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(path))


def assert_leaves(hm, want, pre):
    got = thm.to_numpy(hm)
    names = {k[len(pre):] for k in want if k.startswith(pre)}
    assert set(got) == names, (set(got), names)
    for n in got:
        np.testing.assert_array_equal(got[n], want[pre + n], err_msg=pre + n)


@pytest.mark.parametrize("name", list(CASES))
def test_routed_phases_match_jax(name, jax_out):
    cfg, sb, keys, vals, pq, dq, ik, iv = case_inputs(name)
    mesh = make_serving_mesh(D, device="cpu")
    hs = trlu.build_sharded(cfg, keys, vals, D, sb, device="cpu")
    assert_leaves(hs, jax_out, f"{name}/build/")
    if name == "past_pool":
        lv, pq, dq = past_pool(thm.to_numpy(hs), cfg, sb, pq, dq)
        hs = thm.from_numpy(cfg, lv, device="cpu")
    caps = [trlu.routing_cap(q, cfg, D, sb) for q in (pq, dq, ik)]
    np.testing.assert_array_equal(caps, jax_out[f"{name}/caps"])
    if name == "one_shard":
        assert caps == [pq.size // D, dq.size // D, ik.size // D]
    if name == "overflowed":
        pn = thm.to_numpy(hs)["page_next"]
        assert (pn >= cfg.num_pages).any(), "no chain links past the pool"
    for cap in (None, caps[0]):
        v, f = trlu.probe_sharded(mesh, hs, pq, cfg, cap=cap, shard_by=sb)
        np.testing.assert_array_equal(v.numpy().astype(np.uint32),
                                      jax_out[f"{name}/probe{cap}/v"])
        np.testing.assert_array_equal(f.numpy(),
                                      jax_out[f"{name}/probe{cap}/f"])
    hs2, df = trlu.delete_sharded(mesh, hs, dq, cfg, shard_by=sb)
    np.testing.assert_array_equal(df.numpy(), jax_out[f"{name}/delete_found"])
    assert_leaves(hs2, jax_out, f"{name}/delete/")
    hs3, ok = trlu.insert_mesh(mesh, hs2, ik, iv, cfg, cap=caps[2],
                               shard_by=sb)
    np.testing.assert_array_equal(ok.numpy(), jax_out[f"{name}/insert_ok"])
    assert_leaves(hs3, jax_out, f"{name}/insert/")
    hs4, v, f, df, ok = trlu.tick_mesh(mesh, hs, pq, dq, ik, iv, cfg,
                                       caps=caps, shard_by=sb)
    for k, a in (("v", v), ("f", f), ("df", df), ("ok", ok)):
        got = a.numpy().astype(np.uint32) if k == "v" else a.numpy()
        np.testing.assert_array_equal(got, jax_out[f"{name}/tick_{k}"],
                                      err_msg=k)
    assert_leaves(hs4, jax_out, f"{name}/tick/")
    assert f.any() and df.any() and ok.any()
    if name == "past_pool":                   # F found on shard 0's row P-1
        v, f = trlu.probe_sharded(mesh, hs2, pq[-1:].repeat(D), cfg,
                                  shard_by=sb)
        assert f.all() and (v == 111).all()
