"""PageStore: the interleaved bucket-row layout (paper §2, §2.4).

One page is one DRAM row: ``slots`` interleaved key/value pairs in a single
contiguous ``(num_pages, slots, 2)`` int32 pool (lane 0 = key, lane 1 =
value).  The pool holds uint32 bits in int32 words, so a slot's key and value
are one 8-byte load in the probe kernel and ``pool.numpy().view(np.uint32)``
gives the JAX package's uint32 pool without a copy.

The bit-plane lane (``planes``, the paper's column-oriented key layout,
§2.2) is kept by bit-serial tables: plane j, word w holds bit j of the keys
at slots [32w, 32w+32), LSB first, as ``(num_pages, key_bits, slots // 32)``
int32 words with uint32 bits.  The optional lanes of the JAX store follow:

  * ``fprints`` (``fp_bits > 0``, Dash §4): the low ``fp_bits`` of
    ``fingerprint(key)`` of every slot, packed like ``planes`` into
    ``(num_pages, fp_bits, slots // 32)``.  It is exact per slot: empty and
    tombstoned slots carry the fingerprint of their sentinel, so
    ``fprints == pack_fprints(key_pages, fp_bits)`` always holds;
  * ``stash`` (``stash_slots > 0``, IcebergHT §3): a ``(stash_slots, 2)``
    int32 key/value list, EMPTY keys at first, with its bump pointer
    ``stash_fill``;
  * ``local_depth`` (extendible tables): a ``(num_pages,)`` int32 lane of
    local depths, read at group-head pages.

``write_slots`` and ``write_keys`` keep ``planes`` and ``fprints`` in sync
with the key lane.

Writes follow JAX's ``.at[...].set(mode="drop")``, which indexes by NumPy's
rule: a page id in ``[-num_pages, -1]`` wraps to ``num_pages + id``, a slot id
in ``[-slots, -1]`` to ``slots + id``, and a write with any id outside its
range is dropped (``wrap_index``).  torch has no drop mode, so the copy a
write makes has one spare row past the pool, the dropped writes land there,
and the new pool is the view of the first ``num_pages`` rows: no
data-dependent mask, so a pool write never waits for the device.  Writes
return a new store and leave the old one as it was, as the JAX store's do.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.hashing import (EMPTY_KEY, MASK32, TOMBSTONE_KEY,
                                      fingerprint)

KEY_LANE = 0
VAL_LANE = 1

I32 = torch.int32
I64 = torch.int64

# pack_bitplanes works on blocks of pages whose (pages, S, b) int64 bit
# tensor stays near this size, so its peak is near the pool's own.
PACK_BYTES = 1 << 30


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (the current one, with its index, so that it
    compares equal to a tensor's device).  Naming ``"cpu"`` is the only way
    to run the plain PyTorch versions; asking for CUDA where there is none
    raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
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

    def _packed_lanes(self, pages, slots_idx, keys) -> dict:
        """``planes`` and ``fprints`` after writing ``keys`` at (``pages``,
        ``slots_idx``), for the lanes the store keeps."""
        out = {}
        if self.planes is not None:
            out["planes"] = update_bitplanes_batch(self.planes, pages,
                                                   slots_idx, keys,
                                                   self.key_bits)
        if self.fprints is not None:
            out["fprints"] = update_bitplanes_batch(
                self.fprints, pages, slots_idx,
                fingerprint(from_bits(keys), self.fp_bits), self.fp_bits)
        return out

    def _pool_with_drop_row(self) -> torch.Tensor:
        """A copy of the pool with one spare row past it: ``ext[:P]`` is
        the new pool, and dropped writes land in row P."""
        P = self.num_pages
        ext = self.pool.new_empty((P + 1,) + tuple(self.pool.shape[1:]))
        ext[:P] = self.pool
        return ext

    def _drop_index(self, pages, slots_idx):
        """Scatter indices of each (page, slot), wrapped as ``wrap_index``
        does: a write with an id out of range writes slot 0 of the spare
        row, so the drop needs no data-dependent mask (no wait for the
        device)."""
        P, S = self.pool.shape[:2]
        p, s = wrap_index(pages, P), wrap_index(slots_idx, S)
        m = (p < P) & (s < S)
        return torch.where(m, p, P), torch.where(m, s, 0)

    def write_slots(self, pages, slots_idx, keys, vals) -> "PageStore":
        """ONE pool scatter writes key and value (int32 bits) into the same
        rows; a page id outside the pool drops its write, and the bit-planes
        and fingerprints follow when present.  In-range (page, slot) pairs
        must be unique within the batch."""
        kv = torch.stack([keys.to(I32), vals.to(I32)], dim=-1)
        ext = self._pool_with_drop_row()
        ext[self._drop_index(pages, slots_idx)] = kv
        return dataclasses.replace(
            self, pool=ext[:self.num_pages],
            **self._packed_lanes(pages, slots_idx, keys))

    def write_keys(self, pages, slots_idx, keys,
                   plane_pages=None) -> "PageStore":
        """Key-lane-only scatter (tombstone writes): the value lane of the
        row is left untouched.  ``plane_pages`` optionally overrides the
        page ids used for the bit-plane and fingerprint updates (delete
        drops duplicate targets there)."""
        ext = self._pool_with_drop_row()
        ext[self._drop_index(pages, slots_idx) + (KEY_LANE,)] = keys.to(I32)
        pp = pages if plane_pages is None else plane_pages
        return dataclasses.replace(self, pool=ext[:self.num_pages],
                                   **self._packed_lanes(pp, slots_idx, keys))


def wrap_index(ids, n: int) -> torch.Tensor:
    """int64 ids under NumPy's indexing rule for an axis of length ``n``:
    ``[-n, -1]`` wraps to ``id + n``; every id outside ``[-n, n)`` becomes
    ``n``, the marker of a dropped write."""
    ids = torch.as_tensor(ids).to(I64)
    ids = torch.where(ids < 0, ids + n, ids)
    return torch.where((ids >= 0) & (ids < n), ids, n)


def empty_store(num_pages: int, slots: int, key_bits: int = 32,
                device=None, with_planes: bool = False, fp_bits: int = 0,
                stash_slots: int = 0,
                local_depth: Optional[int] = None) -> PageStore:
    """Fresh PageStore: every key EMPTY, every value 0, no chains.

    ``with_planes`` adds the bit-plane lane, all ones as EMPTY's bits;
    ``fp_bits > 0`` the fingerprint lane, holding EMPTY's fingerprint in
    every slot; ``stash_slots > 0`` the stash (EMPTY keys, fill 0);
    ``local_depth`` (an int) the extendible depth lane, filled with it."""
    dev = resolve_device(device)
    planes = fprints = stash = stash_fill = depths = None
    if with_planes:
        planes = torch.full((num_pages, key_bits, plane_words(slots)), -1,
                            dtype=I32, device=dev)
    if fp_bits > 0:
        efp = int(fingerprint(torch.tensor(EMPTY_KEY), fp_bits))
        words = torch.tensor([-((efp >> j) & 1) for j in range(fp_bits)],
                             dtype=I32, device=dev)   # 0 or all ones a plane
        fprints = words[None, :, None].expand(
            num_pages, fp_bits, plane_words(slots)).contiguous()
    if stash_slots > 0:
        stash = torch.zeros((stash_slots, 2), dtype=I32, device=dev)
        stash[:, KEY_LANE] = EMPTY_BITS
        stash_fill = torch.zeros((), dtype=I32, device=dev)
    if local_depth is not None:
        depths = torch.full((num_pages,), local_depth, dtype=I32, device=dev)
    return PageStore(
        pool=empty_pool(num_pages, slots, dev),
        page_next=torch.full((num_pages,), -1, dtype=I32, device=dev),
        page_fill=torch.zeros((num_pages,), dtype=I32, device=dev),
        free_top=torch.zeros((), dtype=I32, device=dev),
        key_bits=key_bits,
        planes=planes,
        fprints=fprints,
        stash=stash,
        stash_fill=stash_fill,
        local_depth=depths,
        fp_bits=fp_bits,
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


# ---------------------------------------------------------------------------
# Bit-plane packing (the paper's column-oriented key layout)
# ---------------------------------------------------------------------------

def plane_words(slots: int) -> int:
    """Words per plane row; bit-planes need whole 32-slot words."""
    if slots % 32:
        raise ValueError(f"slots must be a multiple of 32 for bit-plane "
                         f"packing, got {slots}")
    return slots // 32


def pack_bitplanes(key_pages: torch.Tensor, key_bits: int) -> torch.Tensor:
    """(P, S) keys (int32 bits) -> (P, key_bits, S // 32) int32 bit-planes:
    bit i of plane[p, j, w] = bit j of key_pages[p, 32w + i].

    Works on blocks of pages so that the (pages, S, b) bit tensor stays
    near ``PACK_BYTES``: at PAPER_HASHMEM the whole of it would be 43 GB."""
    P, S = key_pages.shape
    W = plane_words(S)
    planes = torch.empty((P, key_bits, W), dtype=I32, device=key_pages.device)
    j = torch.arange(key_bits, device=key_pages.device)
    weights = torch.ones(32, dtype=I64, device=key_pages.device) << \
        torch.arange(32, device=key_pages.device)
    block = max(1, PACK_BYTES // (S * key_bits * 8))
    for lo in range(0, P, block):
        kp = key_pages[lo:lo + block].to(I64) & MASK32
        bits = (kp[:, :, None] >> j) & 1                      # (p, S, b)
        bits = bits.transpose(1, 2).reshape(-1, key_bits, W, 32)
        planes[lo:lo + block] = to_bits((bits * weights).sum(-1))
    return planes


def pack_fprints(key_pages: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """The fingerprint lane of a (P, S) key lane (int32 bits):
    ``pack_bitplanes(fingerprint(key_pages), fp_bits)``, a block of pages
    at a time so the int64 fingerprints stay near ``PACK_BYTES``."""
    P, S = key_pages.shape
    out = torch.empty((P, fp_bits, plane_words(S)), dtype=I32,
                      device=key_pages.device)
    block = max(1, PACK_BYTES // (S * 8))
    for lo in range(0, P, block):
        out[lo:lo + block] = pack_bitplanes(
            fingerprint(from_bits(key_pages[lo:lo + block]), fp_bits),
            fp_bits)
    return out


def unpack_bitplanes(planes: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Inverse of pack_bitplanes: (P, b, W) -> (P, 32W) int32 key bits
    (the low ``key_bits`` bits of each key, the rest zero)."""
    P, b, W = planes.shape
    if b != key_bits:
        raise ValueError(f"planes hold {b} bits, key_bits is {key_bits}")
    i = torch.arange(32, device=planes.device)
    bits = (from_bits(planes)[..., None] >> i) & 1            # (P, b, W, 32)
    bits = bits.reshape(P, b, W * 32).transpose(1, 2)         # (P, S, b)
    j = torch.arange(key_bits, device=planes.device)
    return to_bits((bits << j).sum(-1))


def update_bitplanes_batch(planes: torch.Tensor, pages, slots_idx, new_keys,
                           key_bits: int) -> torch.Tensor:
    """Bit-planes after writing ``new_keys`` (int32 bits or uint32 values)
    at (``pages``, ``slots_idx``); ids wrap as ``wrap_index`` does, and an
    id out of range drops its update, as it drops the pool write.

    The JAX package merges each written (page, word) with scatter-adds over
    a full (P, b, W) temporary, which act as OR because every in-range
    (page, slot) pair is unique within a batch.  This form gathers and
    rewrites only the written (page, word) pairs; its adds are int64
    masked to 32 bits, so it gives the same words as the uint32 adds for
    any batch.  Returns a new tensor; ``planes`` is left as it was."""
    P, b, W = planes.shape
    if b != key_bits:
        raise ValueError(f"planes hold {b} bits, key_bits is {key_bits}")
    pages = wrap_index(torch.as_tensor(pages, device=planes.device), P)
    slots_idx = wrap_index(torch.as_tensor(slots_idx, device=planes.device),
                           32 * W)
    keys = torch.as_tensor(new_keys, device=planes.device).to(I64) & MASK32
    m = (pages < P) & (slots_idx < 32 * W)
    pages, slots_idx, keys = pages[m], slots_idx[m], keys[m]
    flat = pages * W + slots_idx // 32
    bit = slots_idx % 32
    uniq, inv = torch.unique(flat, return_inverse=True)
    clear = torch.zeros(uniq.shape, dtype=I64, device=planes.device) \
        .index_add_(0, inv, torch.ones_like(bit) << bit)
    setb = torch.zeros((uniq.numel(), key_bits), dtype=I64,
                       device=planes.device)
    for j in range(key_bits):        # one plane at a time: no (B, b) temporary
        setb[:, j].index_add_(0, inv, ((keys >> j) & 1) << bit)
    pg, wd = uniq // W, uniq % W
    out = planes.clone()
    out[pg, :, wd] = (out[pg, :, wd] & ~to_bits(clear)[:, None]) \
        | to_bits(setb)
    return out
