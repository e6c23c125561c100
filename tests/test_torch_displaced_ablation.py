"""Parity of the port's displaced tables with the JAX package:
``rows_activated_per_probe``, the fingerprint on/off ablation, and a JAX
displaced table carried in. Tolerance 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm

import fp_ablation
from model import mine_bucket_colliding_keys
from hashmap_cases import assert_same_state, jcfg
import torch_threads
from displaced_cases import (
    CPU, assert_same_probes, both_delete, both_insert, dcfg, fp_table,
    j_insert)

one_thread = torch_threads.one_thread

j_rows = jax.jit(jhm.rows_activated_per_probe, static_argnums=2)


# ---------------------------------------------------------------------------
# Rows activated, the ablation, tables carried across
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_fingerprints", [True, False])
def test_rows_activated_matches_jax(use_fingerprints):
    """On a displaced table with chains and a stash (one-bucket keys) and
    on a chained table with fingerprints: hits, misses and stash keys."""
    cfg = dcfg("perf", overflow_pages=8, max_chain=2)
    keys = mine_bucket_colliding_keys(72, cfg.num_buckets, same_b2=True)
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    t, j, _ = both_insert(t, j, keys, keys)
    t2, j2, keys2, rng = fp_table(seed=1, fp_bits=4)
    miss = rng.choice(0xFFFFFFF0, 64).astype(np.uint32)
    for tt, jj, q in [(t, j, keys), (t, j, miss),
                      (t2, j2, np.concatenate([keys2[::3], miss]))]:
        got = thm.rows_activated_per_probe(tt, q, use_fingerprints)
        want = j_rows(jj, jnp.asarray(q), use_fingerprints)
        assert got.dtype == torch.float32
        assert float(got) == float(want)


@pytest.mark.parametrize("seed,displacement", [(0, False), (0, True),
                                               (1, False), (1, True)])
def test_fp_ablation_grid_is_bit_equal(seed, displacement):
    """``tests/fp_ablation.py``'s grid through the port: fingerprints on
    and off give equal oks, founds and probes on ``ref`` and ``perf``, and
    equal the DictModel (JAX's side of the grid is ``fp_ablation.py``)."""
    sched = fp_ablation._schedule(seed)
    oracle = fp_ablation._model_run(sched)
    for backend in ("ref", "perf"):
        off = run_port(fp_ablation._cfg(backend, 0, displacement), sched)
        on = run_port(fp_ablation._cfg(backend, 10, displacement), sched)
        assert on == off == oracle, backend


def run_port(jax_cfg, sched) -> list:
    """``fp_ablation._run`` on the port."""
    t = thm.create(HashMemConfig(**dataclasses.asdict(jax_cfg)), device=CPU)
    out = []
    for kind, ks, vs in sched:
        if kind == "grow":
            t = thm.grow(t)
        elif kind == "insert":
            t, ok = thm.insert(t, ks, vs)
            out.append(("insert", ok.tolist()))
        elif kind == "delete":
            t, f = thm.delete(t, ks)
            out.append(("delete", f.tolist()))
        else:
            v, f = thm.probe(t, ks)
            out.append(("probe", v.tolist(), f.tolist()))
    return out


def test_from_numpy_of_jax_displaced_table():
    """A displaced JAX table with stash entries crosses over leaf by leaf
    and goes on mutating as JAX's does."""
    cfg = dcfg("perf", overflow_pages=8, max_chain=2)
    keys = mine_bucket_colliding_keys(80, cfg.num_buckets, same_b2=True)
    j, _ = j_insert(jhm.create(jcfg(cfg)), jnp.asarray(keys[:76]),
                    jnp.asarray(keys[:76]))
    from hashmap_cases import jax_leaves
    t = thm.from_numpy(cfg, jax_leaves(j), device=CPU)
    assert_same_state(t, j)
    assert thm.stats(t)["stash_live"] == 12
    t, j, _ = both_insert(t, j, keys[76:], keys[76:])
    t, j, _ = both_delete(t, j, keys[60:70])
    assert_same_probes(t, j, keys)
    leaves = jax_leaves(j)
    del leaves["stash"]
    with pytest.raises(KeyError):                # the config needs a stash
        thm.from_numpy(cfg, leaves, device=CPU)
