"""The port's rebuild path on the four backends: a grow keeps every probe, and
a short seeded schedule agrees with the ``DictModel`` oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm

from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout

from model import DictModel
from hashmap_cases import assert_same_state
import torch_threads
import resize_cases
from resize_cases import BACKENDS, CPU, both, jcfg, small

_jitted_jax = resize_cases._jitted_jax

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("backend", BACKENDS)
def test_grow_preserves_probe_on_all_backends(backend):
    keys = np.random.default_rng(13).choice(
        2**31, 400, replace=False).astype(np.uint32)
    cfg = small(backend)
    t, tok = thm.insert_auto(thm.create(cfg, device=CPU), keys, keys + 7)
    j, jok = jhm.insert_auto(jhm.create(jcfg(cfg)), jnp.asarray(keys),
                             jnp.asarray(keys + 7))
    assert bool(tok.all())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert_same_state(t, j)
    v, f = thm.probe(t, keys)
    assert bool(f.all()) and np.array_equal(v.numpy(), keys + 7)


# ---------------------------------------------------------------------------
# A short seeded schedule over the four backends (run_schedule's shape)
# ---------------------------------------------------------------------------
OPS = np.array(["insert", "probe", "delete", "grow", "compact"])
WEIGHTS = np.array([0.40, 0.25, 0.20, 0.08, 0.07])


@pytest.mark.parametrize("seed", range(4))
def test_schedule_matches_dict_model(seed):
    """Mixed insert/probe/delete/grow/compact on a plain and a bit-serial
    table: every probe through all four backends agrees with the DictModel,
    stats() invariants hold after each rebuild, planes decode to the key
    lane, and the final leaves equal JAX's after the same schedule."""
    rng = np.random.default_rng(seed)
    plain, bits = list(both(small("perf"))), list(both(small("bitserial")))
    model = DictModel()
    keyspace = rng.choice(100_000, 256, replace=False).astype(np.uint32)

    def pick(n, extra):
        live = np.asarray(model.keys(), np.uint32)
        pool = np.concatenate([live, rng.choice(keyspace, extra)
                               .astype(np.uint32)]) if live.size else keyspace
        return rng.choice(pool, n).astype(np.uint32)

    def invariants(tables, no_tombs):
        for t, _ in tables:
            st = thm.stats(t)
            assert st["live_entries"] == model.live_entries()
            assert not no_tombs or st["tombstones"] == 0
            assert (st["chain_lengths"] >= 1).all()
            assert st["max_chain"] <= t.config.max_chain
            assert int(st["chain_lengths"].sum()) == int(t.free_top)
        t = tables[1][0]
        assert torch.equal(tlayout.unpack_bitplanes(t.planes, 32),
                           t.key_pages)

    for op in list(rng.choice(OPS, 12, p=WEIGHTS)) + ["probe"]:
        if op == "insert":
            ks = rng.choice(keyspace, 8).astype(np.uint32)
            vs = rng.integers(1, 2**31, 8).astype(np.uint32)
            oks = []
            for pair in (plain, bits):
                t, ok = thm.insert(pair[0], ks, vs)
                j, _ = jhm.insert(pair[1], jnp.asarray(ks), jnp.asarray(vs))
                pair[:] = t, j
                oks.append(ok.numpy())
            assert (oks[0] == oks[1]).all()
            model.insert(ks, vs, oks[0])
        elif op == "delete":
            ks = pick(4, 4)
            exp = None
            for pair in (plain, bits):
                t, f = thm.delete(pair[0], ks)
                j, _ = jhm.delete(pair[1], jnp.asarray(ks))
                pair[:] = t, j
                exp = model.delete(ks) if exp is None else exp
                assert (f.numpy() == exp).all()
        elif op == "probe":
            ks = pick(16, 8)
            ev, ef = model.probe(ks)
            ev, ef = np.asarray(ev, np.uint32), np.asarray(ef)
            for t, backend in [(plain[0], b) for b in BACKENDS[:3]] + \
                    [(bits[0], b) for b in BACKENDS]:
                v, f = thm.probe(t, ks, backend=backend)
                assert (f.numpy() == ef).all(), backend
                assert (v.numpy()[ef] == ev[ef]).all(), backend
        else:
            if op == "grow" and plain[0].config.num_buckets >= 64:
                continue
            fn = {"grow": (thm.grow, jhm.grow),
                  "compact": (thm.compact, jhm.compact)}[op]
            for pair in (plain, bits):
                pair[:] = fn[0](pair[0]), fn[1](pair[1])
            invariants((plain, bits), no_tombs=True)
    invariants((plain, bits), no_tombs=False)
    for t, j in (plain, bits):
        assert_same_state(t, j)
