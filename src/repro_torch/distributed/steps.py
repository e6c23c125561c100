"""Step factories of the port (the JAX package's ``distributed/steps.py``).

``build_serve_step`` gives the decode step the serving loop calls: one
``decode_step`` and the greedy next token.  JAX jits it with its parameter
and state shardings; the port runs it eagerly on one card, with no
shardings.  ``build_train_step`` waits for the training stack (ROADMAP
Queue 1 item 13).
"""
from __future__ import annotations

import torch

from repro_torch.models import model


def build_serve_step(cfg, serve_cfg, mesh=None):
    """Returns (serve_step, ctx).  ``serve_step(params, states, tokens, pos,
    block_table) -> (next_tok (B,) int32, logits (B,1,V), states)``;
    ``mesh`` as in ``model.make_decode_ctx``."""
    B = serve_cfg.shape.global_batch
    ctx = model.make_decode_ctx(cfg, serve_cfg, B, mesh=mesh)

    def serve_step(params, states, tokens, pos, block_table):
        logits, new_states = model.decode_step(
            params, cfg, states, tokens, pos, block_table, ctx)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, new_states

    return serve_step, ctx
