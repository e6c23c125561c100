"""Hash-function family for HashMem (paper §2.5, §6 'Hash Function').

Keys are uint32.  torch has no full uint32 arithmetic, so keys are carried as
int64 tensors holding values in [0, 2**32) and every hash masks with
0xFFFFFFFF after each multiply: the low 32 bits survive int64 wraparound, so
the results are bit-equal to the JAX package's uint32 arithmetic.  Bucket
ids come back as int64, ready for indexing.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

# Sentinels: user keys must be < 0xFFFFFFFE (enforced by callers/tests).
EMPTY_KEY = 0xFFFFFFFF
TOMBSTONE_KEY = 0xFFFFFFFE
MAX_USER_KEY = 0xFFFFFFFD

# Keys at or above this floor are reserved: ROUTE_PAD (0xFFFFFFF0, routing
# padding in the sharded layer), and the EMPTY/TOMBSTONE sentinels at the top.
RESERVED_KEY_FLOOR = 0xFFFFFFF0


def as_u32(keys, device) -> torch.Tensor:
    """numpy array, list or tensor of uint32 values -> int64 tensor on
    ``device`` holding them in [0, 2**32).  A 32-bit input crosses to the
    device at 4 bytes per key and is widened there."""
    if isinstance(keys, torch.Tensor):
        t = keys.view(torch.int32) if keys.dtype == torch.uint32 else keys
    else:
        a = np.asarray(keys)
        if a.dtype.kind not in "iu":
            raise TypeError(f"keys must be integers, got {a.dtype}")
        a = a.astype(np.uint32, copy=False).view(np.int32)
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device).to(torch.int64) & MASK32


def murmur3_fmix(keys: torch.Tensor, salt: int = 0x9E3779B9) -> torch.Tensor:
    """Murmur3 32-bit finalizer (full avalanche)."""
    h = (keys & MASK32) ^ salt
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    h = h ^ (h >> 16)
    return h


def mult_shift(keys: torch.Tensor, salt: int = 0x9E3779B9) -> torch.Tensor:
    """Knuth multiplicative hash (weaker; exercises paper's Fig. 4 skew)."""
    h = (keys * 2654435761) & MASK32
    return h ^ (salt & MASK32)


def identity(keys: torch.Tensor, salt: int = 0) -> torch.Tensor:
    del salt
    return keys & MASK32


HASH_FNS = {
    "murmur3_fmix": murmur3_fmix,
    "mult_shift": mult_shift,
    "identity": identity,
}


def hash_to_bucket(keys: torch.Tensor, num_buckets: int,
                   fn: str = "murmur3_fmix",
                   salt: int = 0x9E3779B9) -> torch.Tensor:
    """keys (…,) int64 uint32-values -> bucket ids (…,) int64 in
    [0, num_buckets)."""
    return HASH_FNS[fn](keys, salt) % num_buckets


def bits_used(num_buckets: int) -> int:
    """Exact log2 of a power-of-two directory size (extendible hashing's
    global depth)."""
    d = num_buckets.bit_length() - 1
    if num_buckets <= 0 or (1 << d) != num_buckets:
        raise ValueError(
            f"extendible resize needs a power-of-two directory; "
            f"num_buckets={num_buckets} is not")
    return d


def hash_prefix(keys: torch.Tensor, depth: int, fn: str = "murmur3_fmix",
                salt: int = 0x9E3779B9) -> torch.Tensor:
    """Low-``depth``-bits hash prefix (extendible-hashing bucket resolution)."""
    return HASH_FNS[fn](keys, salt) & ((1 << depth) - 1)


def validate_user_keys(keys, where: str = "insert"):
    """Raise ValueError if any key collides with the reserved pad/sentinel
    range [0xFFFFFFF0, 0xFFFFFFFF]."""
    if isinstance(keys, torch.Tensor):
        keys = as_u32(keys, "cpu").numpy()
    keys = np.asarray(keys).astype(np.uint32, copy=False)
    if keys.size and int(keys.max()) >= RESERVED_KEY_FLOOR:
        bad = int(keys[keys >= RESERVED_KEY_FLOOR][0])
        raise ValueError(
            f"{where} key {bad:#x} collides with the reserved pad/sentinel "
            f"range [{RESERVED_KEY_FLOOR:#x}, 0xffffffff]")


# Fixed salts for the fingerprint lane and the second (displacement) bucket
# choice, as in the JAX package.
FP_SALT = 0x7FEB352D
B2_SALT = 0x68E31DA4


def fingerprint(keys: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """Low ``fp_bits`` of a salted murmur mix (independent of the bucket
    hash)."""
    return murmur3_fmix(keys, FP_SALT) & ((1 << fp_bits) - 1)


def hash_to_bucket2(keys: torch.Tensor, num_buckets: int,
                    fn: str = "murmur3_fmix",
                    salt: int = 0x9E3779B9) -> torch.Tensor:
    """Second bucket choice for displacement inserts (IcebergHT H2)."""
    return HASH_FNS[fn](keys, (salt ^ B2_SALT) & MASK32) % num_buckets
