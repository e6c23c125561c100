"""Parity of the port's routed phases (``rlu.probe_sharded``,
``delete_sharded``, ``insert_mesh``, ``tick_mesh``) with the JAX package's
on a real JAX mesh.  The JAX side needs four devices, so subprocesses
(``--xla_force_host_platform_device_count=4``, as
``tests/test_serving_sharded.py`` runs; a few in parallel) call it
on a few small stacked tables and write every output and stacked leaf to
``.npz`` files; the port, on the CPU in this process, must equal them bit
for bit.

The cases and the JAX side live in ``tests/rlu_cases.py``.  Tables: a
chained ``ref`` table and a chained ``perf`` table (``highbits``),
a displaced one (``mod``), a ``perf`` table whose build overflowed its arena
so that chains link past each shard's pool, the ``ref`` table with a chain
that links past shard 0's pool to a key that only the clamped read finds
(a page id must be clamped to its own shard before the shard's offset is
added, or the read lands in shard 1), and a batch whose keys all route to
one shard (the ``routing_cap`` case).  Caps: the worst case (None) and the
measured need."""
import numpy as np
import pytest

from repro_torch.core import hashmap as thm
from repro_torch.core import rlu as trlu
from repro_torch.launch.mesh import make_serving_mesh

from rlu_cases import (CASES, D, case_inputs, finish_jax_side, past_pool,
                       start_jax_side)
import torch_threads

one_thread = torch_threads.one_thread


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return finish_jax_side(start_jax_side(str(tmp_path_factory.mktemp(
        "mesh"))))


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
