"""End-to-end driver: train a ~100M-parameter llama-family model for a few
hundred steps with the full stack (data pipeline, train step, checkpointing,
straggler monitor), the port of the JAX package's ``examples/train_lm.py``.

    python -m repro_torch.train_lm [--steps 200]            # on the card
    python -m repro_torch.train_lm --steps 20 --device cpu  # plain PyTorch
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import OptimConfig, ShapeConfig, get_config
from repro_torch.launch.train import train
from repro_torch.models.model import count_params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card by "
                         "default")
    args = ap.parse_args(argv)

    # ~100M params: llama3 family scaled to 8 layers / d_model 512
    cfg = get_config("llama3-8b").replace(
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=32_000, vocab_pad_to=256, attn_chunk=256)
    print(f"model: {count_params(cfg)/1e6:.1f}M params")

    shape = ShapeConfig("train", seq_len=512, global_batch=8, kind="train")
    oc = OptimConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)

    _, _, losses, monitor, _ = train(
        cfg, shape, oc, num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=100, log_every=20, device=args.device)
    steps = sorted(losses)
    if steps:
        print(f"loss: {losses[steps[0]]:.3f} -> {losses[steps[-1]]:.3f} "
              f"({len(monitor.flagged)} straggler steps flagged)")
    return losses


if __name__ == "__main__":
    main()
