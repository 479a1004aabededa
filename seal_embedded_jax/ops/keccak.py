"""Batched Keccak-f[1600] / SHAKE-256 (jnp path and dispatch).

The reference runs a scalar Keccak permutation per 136-byte block
(device/lib/shake256/fips202.c, keccakf1600.c).  Here it is a *batched*
permutation: thousands of independent XOF streams (one per PRNG
(seed, counter) pair) advance in lock-step, each 64-bit lane held as a
(lo, hi) uint32 pair, bit-exact.

Key observation exploited here: every reference PRNG call absorbs exactly
72 bytes (64-byte seed + 8-byte counter, rng.h:78-84) < rate 136, so the
absorb phase is a single padded block and the output is a pure function of
(seed, counter, block_index) — ideal for counter-mode parallelism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

RATE_BYTES = 136
RATE_WORDS = 34  # u32 words per block

# Keccak-f[1600] rho offsets, lane i = x + 5y (FIPS 202).
_RHO = (0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14)

_RC = (0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
       0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
       0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
       0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
       0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
       0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
       0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
       0x8000000000008080, 0x0000000080000001, 0x8000000080008008)


def _rol(lo, hi, r: int):
    """Rotate-left a 64-bit lane held as (lo, hi) u32 by static r."""
    r = r % 64
    if r == 0:
        return lo, hi
    if r == 32:
        return hi, lo
    if r < 32:
        nlo = (lo << r) | (hi >> (32 - r))
        nhi = (hi << r) | (lo >> (32 - r))
        return nlo.astype(U32), nhi.astype(U32)
    r -= 32
    nlo = (hi << r) | (lo >> (32 - r))
    nhi = (lo << r) | (hi >> (32 - r))
    return nlo.astype(U32), nhi.astype(U32)


def _round(lo, hi, rc_lo, rc_hi):
    """One Keccak-f[1600] round on lists of 25 (lo, hi) u32 lane pairs.
    rc_lo/rc_hi: the round constant's words (scalar arrays or ints)."""
    # theta
    clo = [lo[x] ^ lo[x + 5] ^ lo[x + 10] ^ lo[x + 15] ^ lo[x + 20] for x in range(5)]
    chi_ = [hi[x] ^ hi[x + 5] ^ hi[x + 10] ^ hi[x + 15] ^ hi[x + 20] for x in range(5)]
    for x in range(5):
        rl, rh = _rol(clo[(x + 1) % 5], chi_[(x + 1) % 5], 1)
        dlo = clo[(x - 1) % 5] ^ rl
        dhi = chi_[(x - 1) % 5] ^ rh
        for y in range(5):
            lo[x + 5 * y] = lo[x + 5 * y] ^ dlo
            hi[x + 5 * y] = hi[x + 5 * y] ^ dhi
    # rho + pi
    blo = [None] * 25
    bhi = [None] * 25
    for x in range(5):
        for y in range(5):
            i = x + 5 * y
            j = y + 5 * ((2 * x + 3 * y) % 5)
            blo[j], bhi[j] = _rol(lo[i], hi[i], _RHO[i])
    # chi
    for y in range(5):
        row_lo = [blo[x + 5 * y] for x in range(5)]
        row_hi = [bhi[x + 5 * y] for x in range(5)]
        for x in range(5):
            lo[x + 5 * y] = row_lo[x] ^ (~row_lo[(x + 1) % 5] & row_lo[(x + 2) % 5])
            hi[x + 5 * y] = row_hi[x] ^ (~row_hi[(x + 1) % 5] & row_hi[(x + 2) % 5])
    # iota
    lo[0] = (lo[0] ^ rc_lo).astype(U32)
    hi[0] = (hi[0] ^ rc_hi).astype(U32)
    return lo, hi


def keccak_f1600(lo, hi):
    """One permutation over state arrays of shape (..., 25) u32 pairs.

    The 24 rounds run under lax.scan over the round-constant table: the
    round body (theta/rho/pi/chi are round-invariant) is traced and
    compiled once instead of 24 times, shrinking the XLA graph ~24x.
    The GPU kernel (ops/kernels/keccak.py) keeps a fully unrolled
    in-register variant on u64 lanes."""
    rc_lo = jnp.asarray([rc & 0xFFFFFFFF for rc in _RC], dtype=U32)
    rc_hi = jnp.asarray([(rc >> 32) & 0xFFFFFFFF for rc in _RC], dtype=U32)

    def step(state, rcs):
        s_lo, s_hi = state
        ll = [s_lo[..., i] for i in range(25)]
        hh = [s_hi[..., i] for i in range(25)]
        ll, hh = _round(ll, hh, rcs[0], rcs[1])
        return (jnp.stack(ll, axis=-1), jnp.stack(hh, axis=-1)), None

    (lo, hi), _ = jax.lax.scan(step, (lo, hi),
                               jnp.stack([rc_lo, rc_hi], axis=-1))
    return lo, hi


def seed_to_words(seed: bytes) -> np.ndarray:
    """64-byte PRNG seed -> 16 u32 LE words."""
    seed = seed.ljust(64, b"\x00")
    return np.frombuffer(seed, dtype="<u4").copy()


def align_seed(seed_words, counters):
    """Insert axes so seed_words (S..., 16) broadcasts against counters
    (S..., extra..., 2) by aligning leading batch dims."""
    seed_words = jnp.asarray(seed_words)
    while seed_words.ndim - 1 < counters.ndim - 1:
        seed_words = seed_words[..., None, :]
    return seed_words


def absorb72(seed_words, counters):
    """Build the post-absorb Keccak state for shake256(seed||counter_le8).

    seed_words: u32 (..., 16) broadcastable against counters
    counters:   uint64-valued array (any shape) — passed as u32 pair via
                (..., 2) or as uint64; here we take (..., 2) u32 (lo, hi).
    Returns state (lo, hi) arrays of shape (..., 25).
    """
    batch_shape = counters.shape[:-1]
    sw = jnp.broadcast_to(align_seed(seed_words, counters),
                          batch_shape + (16,)).astype(U32)
    block = jnp.zeros(batch_shape + (34,), U32)
    block = block.at[..., 0:16].set(sw)
    block = block.at[..., 16].set(counters[..., 0])
    block = block.at[..., 17].set(counters[..., 1])
    # Multi-rate padding: byte 72 ^= 0x1F (word 18), byte 135 ^= 0x80 (word 33).
    block = block.at[..., 18].set(block[..., 18] ^ jnp.asarray(0x1F, U32))
    block = block.at[..., 33].set(block[..., 33] ^ jnp.asarray(0x80000000, U32))
    lo = block[..., 0::2]  # words 2k   -> lane k low
    hi = block[..., 1::2]  # words 2k+1 -> lane k high
    lo = jnp.concatenate([lo, jnp.zeros(batch_shape + (8,), U32)], axis=-1)
    hi = jnp.concatenate([hi, jnp.zeros(batch_shape + (8,), U32)], axis=-1)
    return lo, hi


def _state_to_rate_words(lo, hi):
    """First 136 bytes of state as 34 u32 words."""
    w = jnp.stack([lo[..., :17], hi[..., :17]], axis=-1)
    return w.reshape(w.shape[:-2] + (34,))


def default_impl() -> str:
    """The SHAKE implementation for the default backend: the Pallas kernel
    on a GPU (one launch per squeeze, ops/kernels/keccak.py), the jnp scan
    elsewhere.  Both are bit-identical (tests/test_keccak_kernel.py)."""
    return "kernel" if jax.default_backend() == "gpu" else "jnp"


def shake256_words(seed_words, counters, nblocks: int, impl: str | None = None,
                   nwords: int | None = None):
    """Squeeze nblocks*136 bytes for each (seed, counter) stream.

    counters: u32 (..., 2) pairs.  Returns u32 (..., nblocks*W) words —
    the byte stream in LE word form, with W = nwords or 34: nwords keeps
    only the first rate words of each block.  The sampler QUEUES read one
    word per draw, and emitting all 34 would cost 34x the writeback for
    nothing (values identical; the rest of the squeeze output simply isn't
    materialized).  impl: "kernel", "interpret" (the kernel in Pallas
    interpret mode, for CPU tests) or "jnp"; default_impl() when None.
    """
    impl = impl or default_impl()
    if impl in ("kernel", "interpret"):
        from .kernels.keccak import shake256_words_kernel
        return shake256_words_kernel(seed_words, counters, nblocks,
                                     nwords=nwords,
                                     interpret=impl == "interpret")
    if impl != "jnp":
        raise ValueError(f"unknown SHAKE implementation {impl!r}")
    W = 34 if nwords is None else nwords
    lo, hi = absorb72(seed_words, counters)

    if nblocks == 1:
        lo, hi = keccak_f1600(lo, hi)
        return _state_to_rate_words(lo, hi)[..., :W]

    def step(state, _):
        lo, hi = keccak_f1600(*state)
        return (lo, hi), _state_to_rate_words(lo, hi)[..., :W]

    (_, _), out = jax.lax.scan(step, (lo, hi), None, length=nblocks)
    # out: (nblocks, ..., W) -> (..., nblocks*W)
    out = jnp.moveaxis(out, 0, -2)
    return out.reshape(out.shape[:-2] + (nblocks * W,))


def words_to_bytes_np(words: np.ndarray) -> bytes:
    """Utility (tests): u32 word stream -> bytes."""
    return np.asarray(words, dtype="<u4").tobytes()
