"""Deterministic sharded synthetic data pipeline of the port, copied from the
JAX package's ``data/pipeline.py`` (plain numpy: the same batches bit for bit
for every step, seed and shard).  ``make_batch_specs`` gives the spec of
each input of a batch on a mesh, as JAX's gives its shardings.

Production-shaped: each host generates ONLY its shard of the global batch
(indexed by (step, shard) so restarts are reproducible and elastic re-shards
keep the token stream identical), with background prefetch of the next batch.

The token stream is a mixture of Zipf-distributed unigrams and a repeated
n-gram "grammar" so small models show a real, declining loss curve (pure
uniform noise would pin the loss at log V).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLMData:
    def __init__(self, cfg, shape, *, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1, prefetch: int = 2):
        assert shape.global_batch % num_shards == 0
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = shape.global_batch // num_shards
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._step = 0
        # Zipf-ish unigram distribution over the vocab
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    # --- deterministic batch materialization -----------------------------
    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard_index)
        B, S = self.local_batch, self.shape.seq_len
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            dec_len = min(512, S)
            frames = rng.standard_normal((B, S, cfg.d_model), np.float32)
            toks = rng.choice(cfg.vocab_size, size=(B, dec_len + 1), p=self._p)
            return {"frames": frames.astype(np.float32),
                    "dec_tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)}
        toks = self._grammar_tokens(rng, B, S + 1)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if cfg.family == "vlm":
            P_ = cfg.num_prefix_embeds
            batch["patch_embeds"] = rng.standard_normal(
                (B, P_, cfg.d_model)).astype(np.float32)
            batch["tokens"] = batch["tokens"][:, :S - P_]
            lab = np.full((B, S), -100, np.int64)
            lab[:, P_:] = toks[:, P_ + 1:]
            batch["labels"] = lab.astype(np.int32)
        return batch

    def _grammar_tokens(self, rng, B, n):
        cfg = self.cfg
        base = rng.choice(cfg.vocab_size, size=(B, n), p=self._p)
        mask = rng.random((B, n - 1)) < 0.6
        # inject learnable structure: token t+1 = (3 t + 7) % V on 60% of
        # steps, applied sequentially so the rule holds on the FINAL stream
        for t in range(1, n):
            det = (3 * base[:, t - 1] + 7) % cfg.vocab_size
            base[:, t] = np.where(mask[:, t - 1], det, base[:, t])
        return base

    # --- prefetch iterator -------------------------------------------------
    def _worker(self, start_step: int):
        step = start_step
        while not self._stop.is_set():
            try:
                self._q.put(self.batch_at(step), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self.iterator(0)

    def iterator(self, start_step: int) -> Iterator[dict]:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, args=(start_step,), daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self.close()

    def close(self):
        self._stop.set()



def make_batch_specs(mesh, batch: dict) -> dict:
    """{input name: spec} of a global batch on ``mesh`` (a ``ModelMesh`` or
    a shape): the leading dimension on the batch axes where they divide it
    (``distributed.sharding.batch_specs``).  JAX's trainer draws the whole
    batch (``shard_index=0``, ``num_shards=1``) and places it so; a rank
    keeps its block with ``sharding.local_block``."""
    from repro_torch.distributed.sharding import batch_specs
    return batch_specs(None, mesh, batch)
