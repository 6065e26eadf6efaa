"""32-bit mixing hashes shared bit-exactly by host (numpy) and device (jnp).

The open-addressing k-mer table (reference: seekmer common.py hash index,
SURVEY.md 2.1 C2) is slot-addressed by ``hash_kmer(hi, lo) & mask``. The same
functions run under numpy (index build, oracle) and under jit on the device
(lookup), so constants live here once. All arithmetic is uint32 with
wrap-around semantics; callers pass uint32 arrays (numpy or jax).
"""

from __future__ import annotations

import numpy as np

# murmur3 fmix32 constants
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)
_STASH_SALT = np.uint32(0x7FEB352D)
_SIG_SEED1 = np.uint32(0x2545F491)
_SIG_SEED2 = np.uint32(0x8F1BBCDC)


def mix32(h):
    """murmur3 finalizer; works on numpy or jax uint32 arrays.

    uint32 wraparound is the DEFINED behavior of every multiply/add here;
    np.errstate silences numpy's overflow RuntimeWarning for scalar/array
    inputs (jax arrays never emit it; the context manager is a no-op for
    them)."""
    with np.errstate(over="ignore"):
        h = h ^ (h >> 16)
        h = h * _C1
        h = h ^ (h >> 13)
        h = h * _C2
        h = h ^ (h >> 16)
        return h


def hash_kmer(hi, lo):
    """Main-table slot hash of a (hi, lo) k-mer key. uint32 in/out."""
    with np.errstate(over="ignore"):
        return mix32(hi ^ mix32(lo + _GOLDEN))


def hash_kmer_stash(hi, lo):
    """Independent hash for the stash table."""
    with np.errstate(over="ignore"):
        return mix32(lo ^ mix32(hi + _STASH_SALT))


def sig_fingerprint_init():
    """Initial (h1, h2) accumulators for signature fingerprinting."""
    return _SIG_SEED1, _SIG_SEED2


def sig_fingerprint_step(h1, h2, ec_id_u32):
    """Fold one EC id (uint32; padding sentinel folded like any value) into
    the running 64-bit (h1, h2) signature fingerprint."""
    with np.errstate(over="ignore"):
        h1 = mix32(h1 ^ ec_id_u32)
        h2 = mix32(h2 + ec_id_u32 * _GOLDEN)
        return h1, h2


def sig_slot_hash(h1, h2):
    """Slot hash for the device signature count table."""
    with np.errstate(over="ignore"):
        return mix32(h1 ^ (h2 * _C2))
