"""The shared part of the port's rebuild-path parity tests: the JAX
hashmap jitted while a file runs, small configs, and paired builds."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import HashMemConfig as JaxConfig
from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm

from paged_kv_cases import jitted_jax_page_table

CPU = "cpu"
BACKENDS = ("ref", "perf", "area", "bitserial")


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax():
    """The JAX hashmap's insert, delete, grow and compact jitted while the
    file runs (eager JAX compiles every primitive anew, call after call)."""
    mp = jitted_jax_page_table()
    yield
    mp.undo()


def jcfg(cfg: HashMemConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def small(backend: str, **kw) -> HashMemConfig:
    """The ``test_mutation_diff.py`` table: 8 buckets of 32 slots."""
    return HashMemConfig(num_buckets=8, slots_per_page=32, overflow_pages=24,
                         max_chain=4, backend=backend, auto_grow=False, **kw)


def both(cfg, keys=None, vals=None):
    """The same table in both packages: empty, or after one insert."""
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    if keys is not None:
        t, tok = thm.insert(t, keys, vals)
        j, jok = jhm.insert(j, jnp.asarray(keys), jnp.asarray(vals))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    return t, j


def assert_same_probes(t, j, q):
    for backend in (("perf", "ref") if t.planes is None else BACKENDS):
        tv, tf = thm.probe(t, q, backend=backend)
        jv, jf = jhm.probe(j, jnp.asarray(q), backend=backend)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf), backend)
        np.testing.assert_array_equal(tv.numpy().astype(np.uint32),
                                      np.asarray(jv), backend)
