"""Parity of the port's extendible resize with the JAX package: the churn
differential on four backends and the ``insert_auto`` budgets. Tolerance 0;
the JAX side is set out in ``tests/extendible_cases.py``."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm

from model import DictModel, mine_bucket_colliding_keys
from hashmap_cases import jcfg
import torch_threads
import extendible_cases
from extendible_cases import (
    CPU, assert_same, both, both_insert, ecfg, j_delete, j_probe,
    probe_both)

jitted_jax_loops = extendible_cases.jitted_jax_loops

one_thread = torch_threads.one_thread


# ---------------------------------------------------------------------------
# The churn differential, four backends
# ---------------------------------------------------------------------------
def churn_schedule(cfg):
    colliders = mine_bucket_colliding_keys(48, cfg.num_buckets,
                                           same_b2=False)
    rng = np.random.default_rng(17)
    for step in range(8):
        ins = np.concatenate([
            rng.integers(1, 4000, size=12, dtype=np.uint32),
            colliders[6 * step:6 * (step + 1)]])
        vals = rng.integers(1, 2**20, size=ins.size, dtype=np.uint32)
        dels = rng.integers(1, 4000, size=4, dtype=np.uint32)
        qs = np.concatenate([ins[:8], dels,
                             rng.integers(1, 4000, size=6, dtype=np.uint32)])
        yield ins, vals, dels, qs


def churn_cfg(backend):
    S, mc = (32, 1) if backend == "bitserial" else (4, 3)
    return ecfg(backend=backend, slots_per_page=S, overflow_pages=248,
                max_chain=mc)


@functools.cache
def jax_churn(backend):
    """JAX's run of the churn: (leaves, ok, found, values, found) per step
    and the events.  The ref, perf and area tables hold the same state, so
    the ref run serves all three."""
    from hashmap_cases import jax_leaves
    cfg = jcfg(churn_cfg(backend))
    j = jhm.create(cfg)
    steps, events = [], {}
    for ins, vals, dels, qs in churn_schedule(cfg):
        j, ok = jhm.insert_auto(j, jnp.asarray(ins), jnp.asarray(vals),
                                events=events)
        j, found = j_delete(j, jnp.asarray(dels))
        v, f = j_probe(j, jnp.asarray(qs))
        steps.append((jax_leaves(j), j.config, *map(np.asarray,
                                                    (ok, found, v, f))))
    return steps, events


@pytest.mark.parametrize("backend", ["ref", "perf", "area", "bitserial"])
def test_extendible_churn_differential(backend):
    """Uniform churn plus 6 one-group keys a step: the hot group splits
    mid-churn.  Equal leaves, oks, founds, probes and events after every
    step, and the DictModel agrees."""
    cfg = churn_cfg(backend)
    jsteps, jevents = jax_churn("bitserial" if backend == "bitserial"
                                else "ref")
    t = thm.create(cfg, device=CPU)
    model = DictModel()
    events = {}
    for (ins, vals, dels, qs), (leaves, jc, jok, jfound, jv, jf) in zip(
            churn_schedule(cfg), jsteps):
        t, ok = thm.insert_auto(t, ins, vals, events=events)
        model.insert(ins, vals, ok.numpy())
        t, found = thm.delete(t, dels)
        np.testing.assert_array_equal(found.numpy(), model.delete(dels))
        v, f = thm.probe(t, qs)
        ev, ef = model.probe(qs)
        np.testing.assert_array_equal(f.numpy(), ef)
        np.testing.assert_array_equal(v.numpy()[ef], np.asarray(ev)[ef])
        assert dataclasses.replace(t.config, backend="x") == dataclasses \
            .replace(HashMemConfig(**dataclasses.asdict(jc)), backend="x")
        got = thm.to_numpy(t)
        assert got.keys() == leaves.keys()
        for name in got:
            np.testing.assert_array_equal(got[name], leaves[name], name)
        for a, b in [(ok, jok), (found, jfound), (f, jf)]:
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(v.numpy().astype(np.uint32), jv)
    assert events == jevents
    assert events.get("splits", 0) >= 1 and events.get("rebuilds", 0) == 0


# ---------------------------------------------------------------------------
# insert_auto: separate proactive and reactive grow budgets
# ---------------------------------------------------------------------------
def test_insert_auto_separate_proactive_reactive_budgets():
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=4,
                        max_chain=1, backend="ref", auto_grow=True,
                        hash_fn="identity", max_load_factor=0.5)
    pre = np.arange(14, dtype=np.uint32)
    t, j = both(cfg)
    t, j, ok, _ = both_insert(t, j, pre, pre + 100, "insert_auto")
    assert ok.all() and t.config.num_buckets == 4
    batch = np.asarray([15, 31, 47, 63, 79], np.uint32)
    tev, jev = {}, {}
    t, tok = thm.insert_auto(t, batch, batch * 2, max_grows=2, events=tev)
    j, jok = jhm.insert_auto(j, jnp.asarray(batch), jnp.asarray(batch * 2),
                             max_grows=2, events=jev)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().all() and tev == jev == {"rebuilds": 3}
    assert_same(t, j)
    assert t.config.num_buckets == 32
    v, f = probe_both(t, j, np.concatenate([pre, batch]))
    assert f.all()


def test_insert_auto_reactive_budget_still_bounds():
    cfg = HashMemConfig(num_buckets=4, slots_per_page=2, overflow_pages=4,
                        max_chain=1, backend="ref", auto_grow=True,
                        hash_fn="identity", max_load_factor=1.0)
    batch = np.asarray([3, 7, 11], np.uint32)
    t, j = both(cfg)
    t, tok = thm.insert_auto(t, batch, batch, max_grows=0)
    j, jok = jhm.insert_auto(j, jnp.asarray(batch), jnp.asarray(batch),
                             max_grows=0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().sum() == 2 and t.config.num_buckets == 4
    assert_same(t, j)
