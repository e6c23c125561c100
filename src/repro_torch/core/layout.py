"""PageStore: the interleaved bucket-row layout (paper §2, §2.4).

One page is one DRAM row: ``slots`` interleaved key/value pairs in a single
contiguous ``(num_pages, slots, 2)`` int32 pool (lane 0 = key, lane 1 =
value).  The pool holds uint32 bits in int32 words, so a slot's key and value
are one 8-byte load in the probe kernel and ``pool.numpy().view(np.uint32)``
gives the JAX package's uint32 pool without a copy.

The JAX store's bit-plane, fingerprint, stash and local-depth lanes are not
part of this port yet; their fields stay ``None``.

Writes follow JAX's ``.at[...].set(mode="drop")``: a write whose page id lies
outside ``[0, num_pages)`` is dropped.  torch has no drop mode, so the out of
range rows are masked out before ``index_put_``.  Writes return a new store
and leave the old one as it was, as the JAX store's do.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.hashing import EMPTY_KEY, MASK32, TOMBSTONE_KEY

KEY_LANE = 0
VAL_LANE = 1

I32 = torch.int32


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Naming ``"cpu"`` is the only way to run the
    plain PyTorch versions; asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32-values -> int32 tensor with the same 32 bits."""
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def from_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 uint32-values in [0, 2**32)."""
    return x.to(torch.int64) & MASK32


EMPTY_BITS = EMPTY_KEY - (1 << 32)            # -1
TOMBSTONE_BITS = TOMBSTONE_KEY - (1 << 32)    # -2


@dataclass
class PageStore:
    """Interleaved page pool + per-page bookkeeping."""

    pool: torch.Tensor            # (num_pages, slots, 2) int32 (uint32 bits)
    page_next: torch.Tensor       # (num_pages,) int32, -1 terminal
    page_fill: torch.Tensor       # (num_pages,) int32 fill high-water mark
    free_top: torch.Tensor        # () int32 pim_malloc bump pointer
    key_bits: int = 32
    planes: Optional[torch.Tensor] = None
    fprints: Optional[torch.Tensor] = None
    stash: Optional[torch.Tensor] = None
    stash_fill: Optional[torch.Tensor] = None
    local_depth: Optional[torch.Tensor] = None
    fp_bits: int = 0

    @property
    def key_pages(self) -> torch.Tensor:
        return self.pool[..., KEY_LANE]

    @property
    def val_pages(self) -> torch.Tensor:
        return self.pool[..., VAL_LANE]

    @property
    def num_pages(self) -> int:
        return self.pool.shape[0]

    def _in_range(self, pages: torch.Tensor) -> torch.Tensor:
        return (pages >= 0) & (pages < self.num_pages)

    def write_slots(self, pages, slots_idx, keys, vals) -> "PageStore":
        """ONE pool scatter writes key and value (int32 bits) into the same
        rows; a page id outside the pool drops its write.  In-range
        (page, slot) pairs must be unique within the batch."""
        m = self._in_range(pages)
        kv = torch.stack([keys.to(I32), vals.to(I32)], dim=-1)
        pool = self.pool.clone()
        pool[pages[m].long(), slots_idx[m].long()] = kv[m]
        return dataclasses.replace(self, pool=pool)

    def write_keys(self, pages, slots_idx, keys) -> "PageStore":
        """Key-lane-only scatter (tombstone writes): the value lane of the
        row is left untouched."""
        m = self._in_range(pages)
        pool = self.pool.clone()
        pool[pages[m].long(), slots_idx[m].long(), KEY_LANE] = \
            keys.to(I32)[m]
        return dataclasses.replace(self, pool=pool)


def empty_store(num_pages: int, slots: int, key_bits: int = 32,
                device=None) -> PageStore:
    """Fresh PageStore: every key EMPTY, every value 0, no chains."""
    dev = resolve_device(device)
    return PageStore(
        pool=empty_pool(num_pages, slots, dev),
        page_next=torch.full((num_pages,), -1, dtype=I32, device=dev),
        page_fill=torch.zeros((num_pages,), dtype=I32, device=dev),
        free_top=torch.zeros((), dtype=I32, device=dev),
        key_bits=key_bits,
    )


def empty_pool(num_pages: int, slots: int, device=None) -> torch.Tensor:
    """(num_pages, slots, 2) interleaved pool: keys EMPTY, values 0."""
    dev = resolve_device(device)
    pool = torch.zeros((num_pages, slots, 2), dtype=I32, device=dev)
    pool[..., KEY_LANE] = EMPTY_BITS
    return pool


def interleave(key_pages: torch.Tensor, val_pages: torch.Tensor) -> torch.Tensor:
    """Zip split (P, S) key/value arrays into the (P, S, 2) pool layout.
    Accepts int32 bits or int64 uint32-values."""
    return torch.stack([to_bits(key_pages), to_bits(val_pages)], dim=-1)
