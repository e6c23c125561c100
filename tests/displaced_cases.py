"""The displaced-table helpers of the port's fingerprint, displacement and
stash parity tests: jitted JAX entry points, configs and paired
insert/delete/probe checks."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm

from hashmap_cases import assert_same_state, j_build, jcfg

CPU = "cpu"
BACKENDS = ("ref", "perf", "area", "bitserial")

# the JAX functions under test, compiled once per table shape (eager JAX
# compiles every primitive anew and would dominate the file's time)
j_probe = jax.jit(lambda hm, q: jhm.probe(hm, q, backend="ref"))
j_insert = jax.jit(jhm.insert)
j_delete = jax.jit(jhm.delete)


def dcfg(backend: str, **kw) -> HashMemConfig:
    """``tests/test_mutation_diff.py``'s ``_dcfg``: fingerprints,
    displacement and a stash on 8 buckets of 32 slots."""
    base = dict(num_buckets=8, slots_per_page=32, overflow_pages=24,
                max_chain=4, backend=backend, auto_grow=False,
                displacement=True, fingerprint_bits=8, stash_slots=16)
    base.update(kw)
    return HashMemConfig(**base)


def assert_same_probes(t, j, q):
    """Every backend the port's table has equals JAX's probe."""
    jv, jf = j_probe(j, jnp.asarray(q))
    for backend in BACKENDS if t.planes is not None else BACKENDS[:3]:
        tv, tf = thm.probe(t, q, backend=backend)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf), backend)
        np.testing.assert_array_equal(tv.numpy().astype(np.uint32),
                                      np.asarray(jv), backend)
    return np.asarray(jv), np.asarray(jf)


def both_insert(t, j, keys, vals):
    t, tok = thm.insert(t, keys, vals)
    j, jok = j_insert(j, jnp.asarray(keys), jnp.asarray(vals))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert_same_state(t, j)
    return t, j, tok.numpy()


def both_delete(t, j, keys):
    t, tf = thm.delete(t, keys)
    j, jf = j_delete(j, jnp.asarray(keys))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert_same_state(t, j)
    return t, j, tf.numpy()


def fp_table(seed=0, fp_bits=6):
    """A chained table with fingerprints and chains in both packages."""
    cfg = HashMemConfig(num_buckets=16, slots_per_page=32, overflow_pages=16,
                        max_chain=4, fingerprint_bits=fp_bits)
    rng = np.random.default_rng(seed)
    keys = rng.choice(0xFFFFFFF0, 900, replace=False).astype(np.uint32)
    t = thm.build(cfg, keys, keys, device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys), jnp.asarray(keys))
    assert_same_state(t, j)
    return t, j, keys, rng
