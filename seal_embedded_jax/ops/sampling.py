"""Bit-exact vectorized samplers (jnp, batched over PRNG streams).

Reproduces the reference's samplers (device/lib/sample.c) including their
exact PRNG byte-consumption pattern, but re-designed as batched
counter-mode expansion:

* The reference's rejection loops consume fresh PRNG calls (new counters) per
  rejected value, sequentially.  We exploit a queue equivalence: the extra
  draws form a single ordered queue of counters c+1, c+2, ...; the j-th
  rejected base position consumes queue entries up to (and including) the
  j-th *accepted* queue entry.  So: precompute a bounded queue of draws in
  one batched SHAKE call, compute per-entry acceptance, and rank-select —
  no sequential loop, bit-exact.

* All shapes static; per-stream counters ride as data.  Overflow of the
  static queue bound is detected and surfaced via an `ok` flag (probability
  < 1e-20 per stream at the chosen bounds).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .keccak import shake256_words

U32 = jnp.uint32
I32 = jnp.int32

# Static queue bounds.  Uniform: E[#rejects] = n*p with p = (2^32 mod q)/2^32
# (p <= 0.019 for the supported 27/30-bit chains; ~76 rejects @ n=4096);
# bound is ~ +10 sigma.  Ternary: per 96-byte block E ~ 0.75.
# Queue length does NOT affect output values (only the ok-flag's
# false-negative rate): entries are deterministic in counter order and only
# the consumed prefix feeds the result.
UNIFORM_QUEUE_CAP = 160  # the validated n=4096 default
TERNARY_QUEUE_CAP = 8


def uniform_queue_cap(n: int, p_max: float | None = None) -> int:
    """Queue bound for degree n: E + 8*sigma + 8, rounded up to a
    multiple of 8 (p_max = worst per-word rejection probability of the
    chain; blanket 0.02 when unknown).  Each queue slot costs one Keccak
    permutation per stream, so a chain-aware bound trims real work —
    e.g. 456 vs 528 at n=16384 for the 30-bit chain, and 40 vs 160 for
    27-bit chains at n=4096.  The bound affects ONLY the ok-flag's
    false-negative rate (< 1e-15 per stream at +8 sigma); output values
    are invariant (only the consumed queue prefix feeds the result).
    Reproduces the long-validated 160 at n=4096 / 30-bit."""
    if p_max is None:
        p_max = 0.02
    e = p_max * n
    cap = e + 8.0 * (e * (1.0 - p_max)) ** 0.5 + 8.0
    return max(24, int(-(-cap // 8)) * 8)


def chain_p_max(moduli) -> float:
    """Worst per-word uniform-sampler rejection probability over a prime
    chain: p(q) = (2^32 mod q') / 2^32 with q' scaled per sample.c:46's
    max_multiple bound (the +1 word at the boundary is absorbed by the
    +8 slack in uniform_queue_cap)."""
    return max((2.0 ** 32 - float((0xFFFFFFFF - (0xFFFFFFFF % int(q)) - 1)))
               / 2.0 ** 32 for q in moduli)


def queue_cap_for(n: int, moduli) -> int:
    """Chain-aware uniform queue bound (pass as sample_uniform's
    queue_cap from pipelines where the chain is statically known)."""
    return uniform_queue_cap(n, chain_p_max(moduli))


def _blocks_for_bytes(nbytes: int) -> int:
    return -(-nbytes // 136)


# --------------------------------------------------------------- counters
#
# PRNG call counters are 64-bit in the reference (rng.h:26-30) and are
# carried here as u32 (..., 2) (lo, hi) pairs with full carry propagation,
# so a stream chained across many polys crosses the 2^32 boundary exactly
# like the reference's uint64 (validated against the golden model in
# tests/test_ops.py).  Wrap of the full 64-bit counter triggers a reseed
# in the reference (rng.h:85-91, getrandom) — a non-deterministic host
# action, mirrored at the API layer via reseed_on_overflow().


def counter_zero(batch_shape) -> jnp.ndarray:
    """Fresh per-stream counter pairs, value 0 (prng_randomize_reset)."""
    return jnp.zeros(tuple(batch_shape) + (2,), U32)


def counter_from_int(batch_shape, value: int) -> jnp.ndarray:
    """Counter pairs starting at an arbitrary u64 value (parallel counter
    layouts use i * STRIDE)."""
    lo = jnp.full(tuple(batch_shape), np.uint32(value & 0xFFFFFFFF), U32)
    hi = jnp.full(tuple(batch_shape), np.uint32(value >> 32), U32)
    return jnp.stack([lo, hi], axis=-1)


def _c_add(c, inc):
    """c (..., 2) + inc (u32 scalar/array < 2^32), with carry into hi."""
    inc = jnp.asarray(inc, U32)
    lo = c[..., 0] + inc
    hi = c[..., 1] + (lo < c[..., 0]).astype(U32)
    return jnp.stack([lo, hi], axis=-1)


def _c_offsets(c, offs):
    """c (..., 2) + offs (K,) u32 -> (..., K, 2) queue counter pairs."""
    lo = c[..., 0, None] + offs
    hi = c[..., 1, None] + (lo < c[..., 0, None]).astype(U32)
    return jnp.stack([lo, hi], axis=-1)


def counter_overflowed(before, after):
    """True where the u64 counter wrapped between two points in a stream
    (the reference's `counter == 0` post-increment check, rng.h:85)."""
    return ((after[..., 1] < before[..., 1])
            | ((after[..., 1] == before[..., 1])
               & (after[..., 0] < before[..., 0])))


def reseed_on_overflow(seed_words, before, after, fresh_seed_words):
    """API-layer mirror of rng.h:85-91: where a stream's counter wrapped,
    swap in fresh seed material and reset the counter to 0.

    seed_words (..., 16), before/after (..., 2), fresh_seed_words like
    seed_words (host entropy, e.g. os.urandom -> keccak.seed_to_words).
    Returns (seed_words, counters, reseeded_mask)."""
    wrapped = counter_overflowed(before, after)
    seed_out = jnp.where(wrapped[..., None], fresh_seed_words, seed_words)
    ctr_out = jnp.where(wrapped[..., None], jnp.zeros_like(after), after)
    return seed_out, ctr_out, wrapped


def _words_to_bytes(words):
    """u32 (..., W) -> uint32-valued bytes (..., 4W) (LE order)."""
    b0 = words & 0xFF
    b1 = (words >> 8) & 0xFF
    b2 = (words >> 16) & 0xFF
    b3 = (words >> 24) & 0xFF
    out = jnp.stack([b0, b1, b2, b3], axis=-1)
    return out.reshape(out.shape[:-2] + (words.shape[-1] * 4,))


def _scatter_last(target, idx, vals):
    """target[..., idx[..., m]] = vals[..., m] along the last axis; indices
    equal to target.shape[-1] (and beyond) are dropped."""
    flat_t = target.reshape(-1, target.shape[-1])
    flat_i = idx.reshape(-1, idx.shape[-1])
    flat_v = vals.reshape(-1, vals.shape[-1])
    rows = jnp.arange(flat_t.shape[0])[:, None]
    flat_t = flat_t.at[rows, flat_i].set(flat_v, mode="drop")
    return flat_t.reshape(target.shape)


# Chunk width for the hierarchical rejected-position search: top_k cost
# grows super-linearly in n, so wide rows split into 4096-lane chunks with a per-chunk top_k and a prefix-offset
# merge.  _CHUNK_K = 160 bounds per-chunk rejections at ~+8.7 sigma for
# the 30-bit chains (E ~ 82 per 4096); overflow is detected per chunk
# and surfaces in the ok flag like every other queue truncation.
_CHUNK_N = 4096
_CHUNK_K = 160


def _rejected_positions(rejected, cap: int):
    """Positions of the first `cap` rejected entries of each row, in
    position order (value n where the rank is invalid).  Returns
    (positions (..., cap) i32, num_rejected (...,), ok (...,)).

    key = span - pos for rejected entries (all >= 1, strictly decreasing
    in pos), 0 otherwise; top_k's descending keys = ascending positions.
    (A cumsum + n-wide scatter into a cap-sized target is the alternative;
    it has not been timed on a GPU.)"""
    n = rejected.shape[-1]
    num_rejected = jnp.sum(rejected.astype(I32), axis=-1)
    if n <= _CHUNK_N:
        k = min(cap, n)
        keys = jnp.where(rejected,
                         n - jnp.arange(n, dtype=I32), jnp.zeros((), I32))
        topv, _ = jax.lax.top_k(keys, k)
        pos = n - topv
        if k < cap:
            pos = jnp.concatenate(
                [pos, jnp.full(pos.shape[:-1] + (cap - k,), n, I32)], -1)
        return pos, num_rejected, jnp.ones(num_rejected.shape, bool)

    nch = n // _CHUNK_N
    rch = rejected.reshape(rejected.shape[:-1] + (nch, _CHUNK_N))
    counts = jnp.sum(rch.astype(I32), axis=-1)            # (..., nch)
    ok = jnp.all(counts <= _CHUNK_K, axis=-1)
    span = jnp.arange(_CHUNK_N, dtype=I32)
    keys = jnp.where(rch, _CHUNK_N - span, jnp.zeros((), I32))
    topv, _ = jax.lax.top_k(keys, _CHUNK_K)               # (..., nch, K)
    lpos = _CHUNK_N - topv                                # == _CHUNK_N invalid
    cidx = jnp.arange(nch, dtype=I32)[:, None]
    gpos = jnp.where(lpos == _CHUNK_N, jnp.int32(n),
                     lpos + cidx * jnp.int32(_CHUNK_N))
    # merge: ONE (nch*K)-wide ascending sort — valid positions (ascending
    # within each chunk) interleave globally and invalid slots (== n)
    # sink to the tail; the first `cap` survive (in place of a
    # prefix-offset scatter).
    flat = gpos.reshape(gpos.shape[:-2] + (nch * _CHUNK_K,))
    out = jax.lax.sort(flat, dimension=-1)[..., :cap]
    return out, num_rejected, ok


def _rank_select(base_vals, rejected, queue_vals, queue_acc):
    """Queue equivalence core (gather-free).

    base_vals: (..., n) initial draws; rejected: mask of base rejections.
    queue_vals/queue_acc: (..., CAP) extra draws + acceptance.
    Returns (final_vals, consumed, ok): final value per position, number of
    queue slots consumed, and a validity flag (per stream).

    Correctness: the reference's rejection loop consumes counters c+1, c+2,...
    strictly in order of (position, retry); therefore the j-th rejected base
    position ends up with the j-th accepted value in that counter order.

    Layout note: the rejected->accepted alignment is a *bijection*
    (every rejected position has a unique rank), so instead of gathering
    accepted values into the n base positions (a (..., n)-sized gather from
    a tiny table) we:
      1. compact the accepted queue entries by rank with ONE stable
         cap-wide sort keyed on acceptance,
      2. find the positions of the first CAP rejected entries with
         top_k over a position-encoding key (chunked for wide rows,
         _rejected_positions),
      3. scatter accepted value r onto the (r+1)-th rejected position
         (the one remaining scatter: CAP updates per stream, invalid
         ranks dropped),
      4. derive the consumed-counter as a pure reduction over the
         acceptance cumsum (no position table needed).
    """
    cap = queue_vals.shape[-1]
    n = base_vals.shape[-1]

    # Rank of each accepted queue slot (1-indexed among accepted).
    qrank = jnp.cumsum(queue_acc.astype(I32), axis=-1)
    num_accepted = qrank[..., -1]

    # accepted_vals[r] = value of the (r+1)-th accepted queue slot:
    # stable-sort the queue by acceptance (accepted first) — XLA lowers
    # the cap-wide sort cheaper than the equivalent cap-wide scatter.
    # (Slots past num_accepted hold rejected draws rather than zeros;
    # they are only ever read when the queue overflowed, i.e. ok=False.)
    sort_key = (~queue_acc).astype(I32)
    _, accepted_vals = jax.lax.sort((sort_key, queue_vals), dimension=-1,
                                    is_stable=True, num_keys=1)

    # Positions of the first CAP rejected base entries, in position order
    # (== n where the rank is invalid; ok covers every truncation).
    rej_pos, num_rejected, ok_pos = _rejected_positions(rejected, cap)

    flat_b = base_vals.reshape(-1, n)
    flat_p = rej_pos.reshape(-1, cap)
    flat_v = accepted_vals.reshape(-1, cap)
    rows = jnp.arange(flat_b.shape[0])[:, None]
    final = flat_b.at[rows, flat_p].set(flat_v, mode="drop") \
                  .reshape(base_vals.shape)

    # Consumed slots = queue position of the last needed accepted entry + 1
    # = (count of queue positions with fewer than num_rejected accepted
    # entries so far) + 1 — a pure reduction over qrank, replacing the
    # accepted-position scatter + take_along_axis this used to need.
    before_last = jnp.sum(
        (qrank < num_rejected[..., None]).astype(I32), axis=-1)
    consumed = jnp.where(num_rejected > 0, before_last + 1, 0)
    ok = (num_rejected <= num_accepted) & ok_pos
    return final, consumed.astype(U32), ok


def sample_uniform(seed_words, counter, n: int, q,
                   queue_cap: int | None = None):
    """sample_poly_uniform (sample.c:39-57), batched.

    seed_words: u32 (16,) or broadcastable; counter: u32 (..., 2) (lo, hi)
    u64 PRNG counter pair per stream; q: int or Mod (supports per-limb
    traced moduli); queue_cap: static queue bound (queue_cap_for(n,
    chain) from pipelines; conservative default otherwise).
    Returns (poly u32 (..., n), next_counter, ok).
    """
    from .modarith import as_mod, barrett32
    m = as_mod(q)
    max_multiple = m.max_multiple
    nblocks = _blocks_for_bytes(4 * n)
    base_words = shake256_words(seed_words, counter, nblocks)
    base = base_words[..., :n]
    rejected = base >= max_multiple

    # Extra-draw queue: counters counter+1 .. counter+CAP; value = first
    # word (nwords=1: only that word is materialized from each draw).
    cap = queue_cap if queue_cap is not None else uniform_queue_cap(n)
    qcounters = _c_offsets(counter, 1 + jnp.arange(cap, dtype=U32))
    qwords = shake256_words(seed_words, qcounters, 1, nwords=1)
    qvals = qwords[..., 0]
    qacc = qvals < max_multiple

    final, consumed, ok = _rank_select(base, rejected, qvals, qacc)
    poly = barrett32(final, m)
    next_counter = _c_add(counter, 1 + consumed)
    return poly, next_counter, ok


def _ternary_block(seed_words, counter, count_here: int):
    """One 96-byte ternary block + its rejection queue (sample.c:223-241)."""
    base_words = shake256_words(seed_words, counter, 1, nwords=24)
    base_bytes = _words_to_bytes(base_words)  # 96 bytes
    rejected = base_bytes >= 0xFE

    qcounters = _c_offsets(counter,
                           1 + jnp.arange(TERNARY_QUEUE_CAP, dtype=U32))
    qwords = shake256_words(seed_words, qcounters, 1, nwords=1)
    qvals = qwords[..., 0] & 0xFF  # first byte of each 1-byte refill
    qacc = qvals < 0xFE

    # The reference touches only the first count_here bytes of a tail block
    # (sample.c:228), so later rejections consume nothing.
    if count_here < 96:
        rejected = rejected & (jnp.arange(96) < count_here)
    final, consumed, ok = _rank_select(base_bytes, rejected, qvals, qacc)
    vals = (final % 3).astype(I32) - 1  # {0,1,2} -> {-1,0,1}
    return vals, _c_add(counter, 1 + consumed), ok


def sample_ternary(seed_words, counter, n: int):
    """sample_small_poly_ternary_prng_96 (sample.c:218-242), batched.

    counter: u32 (..., 2) u64 pair.  Returns (signed {-1,0,1} i32
    (..., n), next_counter, ok).  The packed 2-bit form for serialization
    derives as signed+1.  Full blocks run under one lax.scan (single
    compiled Keccak body); the tail block, if any, is traced separately.
    """
    nfull, tail = divmod(n, 96)

    def step(carry, _):
        counter, ok = carry
        vals, counter, ok_b = _ternary_block(seed_words, counter, 96)
        return (counter, ok & ok_b), vals

    ok0 = jnp.ones(counter.shape[:-1], bool)
    if nfull > 0:
        (counter, ok), blocks = jax.lax.scan(
            step, (counter, ok0), None, length=nfull)
        # blocks: (nfull, ..., 96) -> (..., nfull*96)
        blocks = jnp.moveaxis(blocks, 0, -2)
        signed = blocks.reshape(blocks.shape[:-2] + (nfull * 96,))
    else:
        ok = ok0
        signed = jnp.zeros(counter.shape[:-1] + (0,), I32)
    if tail:
        vals, counter, ok_t = _ternary_block(seed_words, counter, tail)
        signed = jnp.concatenate([signed, vals[..., :tail]], axis=-1)
        ok = ok & ok_t
    return signed, counter, ok


_HW_TABLE = None


def _popcount8(b):
    """Hamming weight of byte-valued u32 array (sample.c:263-269)."""
    t = b - ((b >> 1) & 0x55)
    t = (t & 0x33) + ((t >> 2) & 0x33)
    return (t + (t >> 4)) & 0x0F


def sample_cbd(seed_words, counter, n: int):
    """sample_poly_cbd_generic_prng_16 (sample.c:311-321), batched.

    No rejection: n/16 fills of 96 bytes each, deterministic counters.
    counter: u32 (..., 2) u64 pair.
    Returns (err i32 (..., n) in [-63, 63], next_counter).
    """
    nfills = -(-n // 16)
    fcounters = _c_offsets(counter, jnp.arange(nfills, dtype=U32))
    words = shake256_words(seed_words, fcounters, 1, nwords=24)
    by = _words_to_bytes(words)  # (..., nfills, 96)
    by = by.reshape(by.shape[:-2] + (nfills * 16, 6))[..., :n, :]
    hw = _popcount8(by)
    val = (hw[..., 0] + hw[..., 1] + _popcount8(by[..., 2] & 0x1F)
           - hw[..., 3] - hw[..., 4] - _popcount8(by[..., 5] & 0x1F))
    return val.astype(I32), _c_add(counter, nfills)


def ternary_to_modq(signed, q: int):
    """{-1,0,1} -> {q-1, 0, 1} mod-q representation (sample.c:98-111)."""
    return jnp.where(signed < 0, jnp.asarray(q - 1, U32),
                     signed.astype(U32)).astype(U32)


def ternary_to_modq_any(signed, q):
    """ternary_to_modq for a static int, Mod, or traced/broadcast modulus."""
    from .modarith import _q
    qv = jnp.asarray(_q(q)).astype(U32)
    return jnp.where(signed < 0, qv - jnp.uint32(1),
                     signed.astype(U32)).astype(U32)
