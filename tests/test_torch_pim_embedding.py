"""Parity of the port's HashMem-backed embeddings
(``repro_torch.core.pim_embedding``) with the JAX package's: the
``DictionaryVocab`` table bit for bit, its rows and found flags for known
and unknown keys through each backend (the OOV row for the unknown), the
looked-up embedding rows, and ``qr_embedding`` on the same tables.  All
exact: integer state, and gathers or one float32 add of the same values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pim_embedding import DictionaryVocab as JVocab
from repro.core.pim_embedding import qr_embedding as j_qr_embedding

from repro_torch.core import hashmap
from repro_torch.core.pim_embedding import (DictionaryVocab, init_qr,
                                            qr_embedding)

from test_torch_hashmap import jax_leaves

CPU = "cpu"


@pytest.fixture(scope="module")
def vocabs():
    rng = np.random.default_rng(0)
    keys = rng.choice(2**31, 3000, replace=False).astype(np.uint32)
    return keys, JVocab(keys), DictionaryVocab(keys, device=CPU)


def test_vocab_table_matches_jax(vocabs):
    _, jv, tv = vocabs
    assert tv.size == jv.size and tv.cfg.__dict__ == jv.cfg.__dict__
    got, want = hashmap.to_numpy(tv.hm), jax_leaves(jv.hm)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("backend", ["ref", "perf", "area"])
def test_vocab_encode_and_lookup_match_jax(vocabs, backend):
    keys, jv, tv = vocabs
    rng = np.random.default_rng(1)
    known = keys[rng.choice(keys.size, 48, replace=False)]
    unknown = (known[:16].astype(np.uint64) + 2**31).astype(np.uint32)
    q = np.concatenate([known, unknown]).reshape(8, 8)
    jrows, jfound = jv.encode(jnp.asarray(q), backend=backend)
    rows, found = tv.encode(q, backend=backend)
    assert rows.shape == (8, 8) and rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert found.sum() == 48 and (rows[~found] == tv.size).all()
    table = np.arange((tv.size + 1) * 3, dtype=np.float32).reshape(-1, 3)
    want = jv.lookup(jnp.asarray(table), jnp.asarray(q), backend=backend)
    got = tv.lookup(torch.from_numpy(table), q, backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qr_embedding_matches_jax():
    params = init_qr(num_rows=100_000, d=8, r_r=256, seed=3, device=CPU)
    assert params["q"].shape == (391, 8) and params["r"].shape == (256, 8)
    ids = np.asarray([3, 99_999, 3, 12345, 0, 2**32 - 17], np.uint32)
    got = qr_embedding(params, ids, 100_000)
    want = j_qr_embedding({k: jnp.asarray(v.numpy())
                           for k, v in params.items()}, jnp.asarray(ids),
                          100_000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), got[2].numpy())
    again = init_qr(num_rows=100_000, d=8, r_r=256, seed=3, device=CPU)
    assert torch.equal(again["q"], params["q"])
