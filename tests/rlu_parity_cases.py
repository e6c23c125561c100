"""The JAX side of the port's routing parity tests: jitted JAX entry
points, one JAX ``bucket_fn`` per router, and stacked-state checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashmap as jhm
from repro.core import rlu as jrlu

from repro_torch.configs import HashMemConfig
from repro_torch.core import rlu as trlu

CPU = "cpu"
HASHES = ("murmur3_fmix", "mult_shift", "identity")

j_iwb = jax.jit(jhm.insert_with_buckets)
j_grow = jax.jit(jhm.grow, static_argnames=("factor", "bucket_fn"))
j_build_sharded = jax.jit(jrlu.build_sharded, static_argnums=(0, 3),
                          static_argnames=("shard_by",))


def padded_insert_with_buckets(hm, keys, vals, b, valid=None):
    n = keys.shape[0]
    m = max(8, 1 << (n - 1).bit_length())

    def pad(a, fill):
        a = jnp.asarray(a)
        return jnp.concatenate([a, jnp.full((m - n,), fill, a.dtype)])

    v = jnp.ones((n,), bool) if valid is None else jnp.asarray(valid)
    hm2, ok = j_iwb(hm, pad(keys, 0), pad(vals, 0), pad(b, 0), pad(v, False))
    return hm2, ok[:n]


@pytest.fixture
def jitted_jax_loops(monkeypatch):
    """The JAX package's host-level loops with two module functions jitted
    (a padded ``insert_with_buckets`` writes nothing for its pads)."""
    monkeypatch.setattr(jhm, "insert_with_buckets", padded_insert_with_buckets)
    monkeypatch.setattr(jhm, "grow", j_grow)


def _keys(rng, n, hi=0xFFFFFFF0):
    return rng.choice(hi, n, replace=False).astype(np.uint32)


# ---------------------------------------------------------------------------
# Sharded build and the routed host-level insert
# ---------------------------------------------------------------------------
def _small_cfg(displaced: bool) -> HashMemConfig:
    if displaced:
        return HashMemConfig(num_buckets=16, slots_per_page=32,
                             overflow_pages=32, max_chain=4, backend="ref",
                             displacement=True, fingerprint_bits=8,
                             stash_slots=16)
    return HashMemConfig(num_buckets=16, slots_per_page=64,
                         overflow_pages=64, max_chain=4, backend="perf")


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
def _j_routes(q, owner, D, c, pad, drop_invalid):
    """JAX's ``_Route`` of each source block."""
    ql = q.size // D
    return [jrlu._Route(jnp.asarray(q[s * ql:(s + 1) * ql]),
                        jnp.asarray(owner[s * ql:(s + 1) * ql]), D, c,
                        jnp.uint32(pad), drop_invalid=drop_invalid)
            for s in range(D)]


def _route_batch(D, ql, skew, seed, pads=0):
    rng = np.random.default_rng(seed)
    cfg = HashMemConfig(num_buckets=32)
    q = rng.integers(0, 2**31, D * ql).astype(np.uint32)
    if skew:                                   # every key owned by shard 0
        cand = np.arange(1, 200_000, dtype=np.uint32)
        cand = cand[trlu.owner_of_np(cand, cfg, D, "highbits") == 0]
        q = rng.choice(cand, D * ql).astype(np.uint32)
    if pads:
        q[rng.choice(q.size, pads, replace=False)] = trlu.ROUTE_PAD
    return cfg, q
