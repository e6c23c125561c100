"""Channel-level parallelism (paper §6 future work, implemented): a HashMem
split into 8 channel shards, probes routed to their owners, and the
replicated throughput mode.

    python -m repro_torch.channels_demo                 # on the card
    python -m repro_torch.channels_demo --device cpu    # plain PyTorch

The steps and sizes of the JAX package's ``examples/channels_demo.py``:
60k pairs built into 8 shards (bucket ownership = h mod 8), 4096 hits and
1024 misses probed through ``rlu.probe_sharded`` and checked, then the
same probes through ``rlu.probe_replicated`` on one unsharded table.  JAX
lays the 8 shards over 8 devices; here they are stacked on one device and
the routed probe is one kernel launch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap, rlu
from repro_torch.launch.mesh import make_serving_mesh


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None):
    mesh = make_serving_mesh(8, device=device)
    cfg = HashMemConfig(num_buckets=256, slots_per_page=256,
                        overflow_pages=256, max_chain=4, backend="perf")
    rng = np.random.default_rng(0)
    n = 60_000
    keys = rng.choice(2**31, size=n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 2**31, size=n).astype(np.uint32)

    print("building 8 channel shards (bucket ownership = h mod 8)...")
    hm8 = rlu.build_sharded(cfg, keys, vals, num_shards=8,
                            device=mesh.device)

    q = np.concatenate([keys[:4096],
                        (keys[:1024].astype(np.uint64) + 2**31)
                        .astype(np.uint32)])
    t0 = time.perf_counter()
    v, f = rlu.probe_sharded(mesh, hm8, q, cfg)
    _sync(mesh.device)
    dt = time.perf_counter() - t0
    v, f = v.cpu().numpy(), f.cpu().numpy()
    if not (f[:4096].all() and (v[:4096] == vals[:4096]).all()
            and not f[4096:].any()):
        raise AssertionError("channel-parallel probe returned wrong results")
    print(f"channel-parallel probe of {len(q)} keys across 8 channels on "
          f"{mesh.device}: hits+misses correct ({dt * 1e3:.1f} ms, first "
          f"call)")

    # throughput mode: one replicated table, the probes split over 'data'
    hm = hashmap.build(cfg, keys, vals, device=mesh.device)
    v2, f2 = rlu.probe_replicated(mesh, hm, q, cfg, axis="data")
    if not (f2[:4096].all() and (v2[:4096].cpu().numpy()
                                 == vals[:4096]).all()):
        raise AssertionError("replicated probe returned wrong results")
    print("replicated throughput mode: correct")
    return hm8, hm


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; the card by "
                         "default")
    main(ap.parse_args().device)
