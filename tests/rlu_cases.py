"""The small stacked tables on which the port's routed phases are held
against the JAX package's (``CASES``), their seeded inputs, and the JAX
side: a few subprocesses, with four forced XLA devices (as
``tests/test_serving_sharded.py`` runs), that call JAX's
``probe_sharded``, ``delete_sharded``, ``insert_mesh`` and ``tick_mesh`` on
its cases and write every output and stacked leaf to an ``.npz``.  Shared by
``test_torch_rlu_mesh_parity.py`` (the stacked backend) and
``test_torch_rlu_ranks.py`` (one shard a rank); imports no JAX itself."""
import os
import subprocess
import sys
import textwrap

import numpy as np

from repro_torch.configs import HashMemConfig
from repro_torch.core import rlu as trlu

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
from rlu_cases import CASES, D, case_inputs, past_pool

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
for name in {names!r}:
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




def start_jax_side(out_dir: str, procs: int = 4) -> list:
    """Start the JAX side in ``procs`` subprocesses, each on its share of
    the cases (they compile in parallel) and writing
    ``{out_dir}/jax{i}.npz``; ``finish_jax_side`` waits for them and merges
    the files."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={D}"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    names = list(CASES)
    out = []
    for i in range(procs):
        path = os.path.join(out_dir, f"jax{i}.npz")
        code = JAX_SIDE.format(tests=os.path.join(ROOT, "tests"), path=path,
                               names=names[i::procs])
        out.append((subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env), path))
    return out


def finish_jax_side(procs: list) -> dict:
    out = {}
    for proc, path in procs:
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
        out.update(np.load(path))
    return out


def kill_jax_side(procs: list):
    for proc, _ in procs:
        proc.kill()
        proc.wait()
