"""SHAKE-256 squeeze as one Pallas kernel for NVIDIA GPUs (Triton route).

Every reference PRNG call absorbs exactly 72 bytes (64-byte seed + 8-byte
counter, rng.h:78-84), so each (seed, counter) stream is one padded absorb
block followed by ``nblocks`` Keccak-f[1600] permutations, each emitting
the first ``nwords`` of its 34 rate words.

One thread owns one stream.  Its 25 lanes stay in registers as u64 for
the whole squeeze, and one launch runs the absorb, every permutation and
every rate-word store: the XLA form of the same squeeze is a scan over
blocks around a scan over rounds, one small launch per step.  A program
handles ``32 * num_warps`` consecutive streams.  Outputs are stored
word-major, row ``block * nwords + word`` and one column per stream, so
each store writes consecutive streams and is coalesced; the wrapper
transposes back to the stream-major layout of ``ops.keccak``.

Bit-exact against hashlib's SHAKE-256 and the jnp Keccak
(tests/test_keccak_kernel.py runs the kernel in interpret mode).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..keccak import _RC, _RHO, align_seed

U32 = jnp.uint32
U64 = jnp.uint64

# pi as a gather: output lane x + 5y of a round's rho/pi step reads input
# lane PI_INV[x + 5y] (FIPS 202: lane (x, y) moves to (y, 2x + 3y)).
PI_INV = [0] * 25
for _x in range(5):
    for _y in range(5):
        PI_INV[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
del _x, _y


def _rotl(x, r: int):
    r %= 64
    if r == 0:
        return x
    return (x << r) | (x >> (64 - r))


# Round constants padded to a power of two (Triton loads need one).
RC_TABLE = np.array(_RC + (0,) * 8, np.uint64)


def _round(a, rc):
    """One Keccak-f[1600] round on a list of 25 u64 lanes (lane x + 5y).
    Rho/pi and chi are fused per output row, so each theta'd lane is
    rotated where its one chi consumer reads it.  Chi's ~b1 & b2 is
    written b2 ^ (b1 & b2): a u64 NOT would need the constant 2^64 - 1."""
    c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
         for x in range(5)]
    d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
    new = [None] * 25
    for y in range(5):
        b = []
        for x in range(5):
            i = PI_INV[x + 5 * y]
            b.append(_rotl(a[i] ^ d[i % 5], _RHO[i]))
        for x in range(5):
            b1, b2 = b[(x + 1) % 5], b[(x + 2) % 5]
            new[x + 5 * y] = b[x] ^ b2 ^ (b1 & b2)
    new[0] = new[0] ^ rc
    return new


def permute(a, rc_ref):
    """Keccak-f[1600]: a loop of 24 rounds over the round constants in
    ``rc_ref`` (RC_TABLE).  The unrolled form compiled for 200 s instead of
    1 s on an H100 and ran slower (PERF.md, Findings)."""
    return list(jax.lax.fori_loop(
        0, 24, lambda r, a: tuple(_round(list(a), rc_ref[r])), tuple(a)))


def absorb(seed_lo_hi, ctr):
    """Post-absorb lanes for shake256(seed || counter_le8).

    seed_lo_hi: 16 u32 seed words (any common shape); ctr: the two u32
    counter words.  Lanes 0-7 hold the seed, lane 8 the counter, and the
    multi-rate padding puts 0x1F in byte 72 (lane 9) and 0x80 in byte 135
    (top byte of lane 16); the capacity lanes are zero."""
    w = [x.astype(U64) for x in seed_lo_hi]
    zero = jnp.zeros_like(w[0])
    lanes = [w[2 * k] | (w[2 * k + 1] << 32) for k in range(8)]
    lanes.append(ctr[0].astype(U64) | (ctr[1].astype(U64) << 32))
    lanes.append(zero | np.uint64(0x1F))
    lanes += [zero] * 6
    lanes.append((zero | np.uint64(0x80)) << 56)
    lanes += [zero] * 8
    return lanes


def _kernel(rc_ref, seed_ref, ctr_ref, out_ref, *, nblocks: int,
            nwords: int):
    """seed (16, S), ctr (2, S), out (nblocks * nwords, S) for S streams."""
    st = absorb([seed_ref[w, :] for w in range(16)],
                [ctr_ref[0, :], ctr_ref[1, :]])

    def emit(j, st):
        for k in range(nwords):
            lane = st[k // 2]
            word = lane if k % 2 == 0 else lane >> 32
            out_ref[j * nwords + k, :] = word.astype(U32)

    if nblocks == 1:
        emit(0, permute(st, rc_ref))
        return

    def body(j, st):
        st = permute(list(st), rc_ref)
        emit(j, st)
        return tuple(st)

    jax.lax.fori_loop(0, nblocks, body, tuple(st))


def launch_shape(nblocks: int) -> tuple[int, int]:
    """(streams per program, warps per program).  Long squeezes come in
    few streams (one per message), so they take one warp per program to
    spread over as many SMs as there are warps; single-block calls have
    hundreds of thousands of streams and take four."""
    num_warps = 1 if nblocks > 1 else 4
    return 32 * num_warps, num_warps


@lru_cache(maxsize=32)
def _squeeze_call(npad: int, nblocks: int, nwords: int, interpret: bool):
    bs, num_warps = launch_shape(nblocks)
    rows = nblocks * nwords
    return pl.pallas_call(
        partial(_kernel, nblocks=nblocks, nwords=nwords),
        out_shape=jax.ShapeDtypeStruct((rows, npad), U32),
        grid=(npad // bs,),
        in_specs=[pl.BlockSpec((RC_TABLE.size,), lambda i: (0,)),
                  pl.BlockSpec((16, bs), lambda i: (0, i)),
                  pl.BlockSpec((2, bs), lambda i: (0, i))],
        out_specs=pl.BlockSpec((rows, bs), lambda i: (0, i)),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name="shake256_squeeze",
    )


def shake256_words_kernel(seed_words, counters, nblocks: int,
                          nwords: int | None = None,
                          interpret: bool = False):
    """Drop-in for ops.keccak.shake256_words through the kernel.

    seed_words: u32 (..., 16) broadcastable against counters (..., 2).
    Returns u32 (..., nblocks * W) with W = nwords or 34: the first W rate
    words of each squeezed block.  ``interpret`` runs the kernel in Pallas
    interpret mode (CPU tests)."""
    batch_shape = counters.shape[:-1]
    W = 34 if nwords is None else nwords
    N = int(np.prod(batch_shape)) if batch_shape else 1
    sw = jnp.broadcast_to(align_seed(seed_words, counters),
                          batch_shape + (16,)).astype(U32).reshape(N, 16)
    ctr = counters.astype(U32).reshape(N, 2)
    bs, _ = launch_shape(nblocks)
    npad = -(-N // bs) * bs
    if npad != N:
        sw = jnp.pad(sw, ((0, npad - N), (0, 0)))
        ctr = jnp.pad(ctr, ((0, npad - N), (0, 0)))
    out = _squeeze_call(npad, nblocks, W, interpret)(
        jnp.asarray(RC_TABLE), sw.T, ctr.T)
    return out[:, :N].T.reshape(batch_shape + (nblocks * W,))
