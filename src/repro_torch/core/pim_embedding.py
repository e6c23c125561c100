"""Hash/dictionary-encoded embedding lookups through HashMem (the JAX
package's ``core/pim_embedding.py``).

Two patterns from the paper's §4.1.1 contract ("string values ...
dictionary-encoded into numerical values to be used in HashMem"):

  * ``DictionaryVocab``: a HashMem mapping raw feature keys (dictionary-
    encoded uint32) -> dense row ids; ``encode`` probes (through any
    backend, the CUDA kernels on the card) and ``lookup`` gathers embedding
    rows.  Unknown keys map to the OOV row: the probe's not-found flag IS
    the OOV signal.
  * ``qr_embedding``: the quotient-remainder trick (Shi et al. 2019) for
    huge vocabularies: row = E_q[h // R_r] + E_r[h % R_r], the hash from the
    paper's family (murmur3 finisher).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap
from repro_torch.core.hashing import HASH_FNS, as_u32
from repro_torch.core.layout import resolve_device


class DictionaryVocab:
    """key -> row-id dictionary backed by a HashMem on ``device`` (None:
    the card)."""

    def __init__(self, keys: np.ndarray, cfg: HashMemConfig | None = None,
                 device=None):
        n = len(keys)
        self.cfg = cfg or HashMemConfig(
            num_buckets=max(64, 1 << int(np.ceil(np.log2(max(n, 1) / 256 + 1)))),
            slots_per_page=512,
            overflow_pages=max(64, n // 256),
            max_chain=8, backend="ref")
        rows = np.arange(n, dtype=np.uint32)
        self.hm = hashmap.build(self.cfg, np.asarray(keys, np.uint32), rows,
                                device=device)
        self.size = n

    def encode(self, raw_keys, backend=None):
        """raw (..,) uint32 -> (row_ids (..,) int32, found (..,) bool);
        not-found -> row ``self.size`` (the OOV row)."""
        q = as_u32(raw_keys, self.hm.device)
        rows, found = hashmap.probe(self.hm, q.reshape(-1), backend=backend)
        rows = torch.where(found, rows, self.size).to(torch.int32)
        return rows.reshape(q.shape), found.reshape(q.shape)

    def lookup(self, table: torch.Tensor, raw_keys, backend=None):
        """table ((size+1), d) with the OOV row last -> embeddings (.., d)."""
        rows, _ = self.encode(raw_keys, backend=backend)
        return table[rows.to(torch.int64)]


def qr_embedding(params: dict, ids, num_rows: int,
                 hash_fn: str = "murmur3_fmix"):
    """Quotient-remainder hash embedding.  params: {'q': (R_q, d),
    'r': (R_r, d)} with R_q = ceil(num_rows / R_r)."""
    h = HASH_FNS[hash_fn](as_u32(ids, params["q"].device)) % num_rows
    r_r = params["r"].shape[0]
    return params["q"][h // r_r] + params["r"][h % r_r]


def init_qr(num_rows: int, d: int, r_r: int = 4096, seed: int = 0,
            device=None) -> dict:
    """Both tables ~ N(0, 0.02^2), drawn from a generator seeded with
    ``seed`` on ``device`` (None: the card)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    r_q = (num_rows + r_r - 1) // r_r
    return {"q": torch.randn((r_q, d), generator=g, device=dev) * 0.02,
            "r": torch.randn((r_r, d), generator=g, device=dev) * 0.02}
