"""Quickstart: build a HashMem, probe it through every backend, mutate it.

    python -m repro_torch.quickstart                 # on the card
    python -m repro_torch.quickstart --device cpu    # plain PyTorch versions

The same steps at the same sizes as the JAX package's
``examples/quickstart.py``: 100k pairs, 10% probed through ``ref``,
``perf`` and ``area``, a ``bitserial`` build and probe, then delete and
insert.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap


def main(device=None):
    # --- the paper's workload, scaled: unique uint32 key/value pairs -----
    rng = np.random.default_rng(0)
    n = 100_000
    keys = rng.choice(2**31, size=n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 2**31, size=n).astype(np.uint32)

    cfg = HashMemConfig(num_buckets=1 << 10, slots_per_page=512,
                        overflow_pages=1 << 8, max_chain=4, backend="perf")
    chk = hashmap.build_check(cfg, keys)
    print(f"build check: max chain {chk['max_chain_needed']}, "
          f"overflow pages {chk['overflow_pages_needed']}, "
          f"load {chk['load_factor']:.2f}")

    # --- bulk build (bucket-per-page layout, overflow chaining) ----------
    hm = hashmap.build(cfg, keys, vals, device=device)
    print(f"device: {hm.device}")

    # --- probe 10% random keys through each compare backend --------------
    q = keys[rng.choice(n, size=n // 10, replace=False)]
    for backend in ("ref", "perf", "area"):
        v, f = hashmap.probe(hm, q, backend=backend)
        if not bool(f.all()):
            raise AssertionError(f"{backend}: built keys not found")
        print(f"probe[{backend:9s}]: {len(q)} keys, all found")

    # --- bit-serial backend needs the column-oriented bit-plane layout ---
    cfg_bs = dataclasses.replace(cfg, backend="bitserial")
    hm_bs = hashmap.build(cfg_bs, keys, vals, device=device)
    v, f = hashmap.probe(hm_bs, q)
    if not bool(f.all()):
        raise AssertionError("bitserial: built keys not found")
    print("probe[bitserial]: all found (b bit-plane steps per probe)")

    # --- delete (tombstones) + insert (pim_malloc overflow) --------------
    hm, found = hashmap.delete(hm, keys[:1000])
    v, f = hashmap.probe(hm, keys[:1000])
    if bool(f.any()):
        raise AssertionError("deleted keys still found")
    newk = (keys[:500].astype(np.uint64) + 2**31).astype(np.uint32)
    hm, ok = hashmap.insert(hm, newk, newk)
    if not bool(ok.all()):
        raise AssertionError("insert refused")
    st = hashmap.stats(hm)
    print(f"after delete+insert: live={st['live_entries']} "
          f"tombstones={st['tombstones']} (not reused, paper §2.5)")
    return st


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain PyTorch versions; the "
                             "card by default")
    main(parser.parse_args().device)
