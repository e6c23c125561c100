"""The JAX side of the port's paged KV parity tests: the JAX hashmap's
page-table calls jitted while a file runs, and the autouse fixtures that
bind them."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import hashmap as jhm

CPU = "cpu"


def _pad(a, fill, m):
    a = jnp.asarray(a)
    return jnp.concatenate([a, jnp.broadcast_to(jnp.asarray(fill, a.dtype),
                                                (m - a.shape[0],))])


def jitted_jax_page_table():
    """The JAX hashmap functions a PageTableManager calls, jitted (eager
    JAX compiles every primitive anew): batches padded to a power of two,
    inserts with ``valid=False`` pads, deletes with copies of their first
    key (a duplicate query tombstones the same slot, JAX's contract).
    Returns a MonkeyPatch context whose exit restores them."""
    j_iwb = jax.jit(jhm.insert_with_buckets)
    j_del = jax.jit(jhm.delete)

    def insert_with_buckets(hm, keys, vals, b, valid=None):
        n = keys.shape[0]
        m = max(8, 1 << (n - 1).bit_length())
        v = jnp.ones((n,), bool) if valid is None else jnp.asarray(valid)
        hm2, ok = j_iwb(hm, _pad(keys, 0, m), _pad(vals, 0, m),
                        _pad(b, 0, m), _pad(v, False, m))
        return hm2, ok[:n]

    def delete(hm, keys):
        n = keys.shape[0]
        m = max(8, 1 << (n - 1).bit_length())
        hm2, found = j_del(hm, _pad(keys, jnp.asarray(keys)[0], m))
        return hm2, found[:n]

    mp = pytest.MonkeyPatch()
    mp.setattr(jhm, "insert_with_buckets", insert_with_buckets)
    mp.setattr(jhm, "delete", delete)
    mp.setattr(jhm, "grow", jax.jit(jhm.grow, static_argnames=("factor",
                                                               "bucket_fn")))
    mp.setattr(jhm, "compact", jax.jit(jhm.compact,
                                       static_argnames=("bucket_fn",)))
    mp.setattr(jhm, "hash_to_bucket", jax.jit(
        jhm.hash_to_bucket, static_argnames=("num_buckets", "fn", "salt")))
    mp.setattr(jhm, "live_count", jax.jit(jhm.live_count))
    mp.setattr(jhm, "chain_lengths", jax.jit(jhm.chain_lengths))
    return mp


@pytest.fixture(scope="module", autouse=True)
def _jitted_page_table():
    mp = jitted_jax_page_table()
    yield
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def _no_grad():
    """The models' parameters carry gradients (the training stack); these
    tests compare values, so they build no autograd graph."""
    with torch.no_grad():
        yield
