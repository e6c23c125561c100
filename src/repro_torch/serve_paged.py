"""Serve a small model with batched requests: continuous batching on top of
the HashMem-managed paged KV cache (pim_malloc allocation, tombstone free),
the page table on a ``perf`` HashMem, whose frees find their keys through
the ``probe_perf`` CUDA kernel on the card (the JAX package's
``examples/serve_paged.py``).

    python -m repro_torch.serve_paged                 # on the card
    python -m repro_torch.serve_paged --device cpu    # plain PyTorch
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; the card by "
                         "default")
    args = ap.parse_args(argv)
    cfg = get_config("qwen3-8b").replace(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=8_000, vocab_pad_to=64, attn_chunk=128)
    done, mgr, steps = serve(
        cfg, batch=4, requests=10, max_new=12, horizon=128,
        page_tokens=32, backend="perf", device=args.device)
    print(f"\npage-table state after drain: live={mgr.live_pages()} "
          f"free={[len(a) for a in mgr.free]}")
    return done, mgr, steps


if __name__ == "__main__":
    main()
