"""Batched ops (jnp path) vs the golden model — bit-exactness on CPU backend."""

import hashlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax.config import default_parms
from seal_embedded_jax.golden import sampling as gs
from seal_embedded_jax.golden.ntt import intt_inpl, ntt_inpl
from seal_embedded_jax.golden.prng import Prng
from seal_embedded_jax.ops import keccak as kc
from seal_embedded_jax.ops import modarith as ma
from seal_embedded_jax.ops import sampling as sp
from seal_embedded_jax.ops import ntt as tntt

P = default_parms(4096, 3)
N, LOGN = P.degree, P.logn
Q = P.moduli[0]


def test_mulhi_mullo_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 20000).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 20000).astype(np.uint32)
    wide = a.astype(np.uint64) * b.astype(np.uint64)
    got_hi, got_lo = map(np.asarray, jax.jit(
        lambda x, y: (ma.mulhi(x, y), ma.mullo(x, y)))(
        jnp.asarray(a), jnp.asarray(b)))
    assert (got_hi == (wide >> 32).astype(np.uint32)).all()
    assert (got_lo == (wide & 0xFFFFFFFF).astype(np.uint32)).all()


@pytest.mark.parametrize("q", list(P.moduli) + [134012929])
def test_mul_mod_exact(q):
    rng = np.random.default_rng(q)
    a = rng.integers(0, 2 ** 32, 5000).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 5000).astype(np.uint32)
    got = np.asarray(jax.jit(partial(ma.mul_mod, q=q))(jnp.asarray(a), jnp.asarray(b)))
    want = ((a.astype(np.uint64) * b.astype(np.uint64)) % q).astype(np.uint32)
    assert (got == want).all()


def test_barrett_wide_edges():
    # Exhaustive-ish edge corners of the 64-bit input space.
    edges = [0, 1, Q - 1, Q, Q + 1, 2 * Q, 2 ** 32 - 1, 2 ** 32, 2 ** 62,
             2 ** 63 - 1, (Q << 32) + 12345]
    for x in edges:
        lo = jnp.asarray([x & 0xFFFFFFFF], jnp.uint32)
        hi = jnp.asarray([(x >> 32) & 0xFFFFFFFF], jnp.uint32)
        got = int(np.asarray(ma.barrett_wide(lo, hi, Q))[0])
        assert got == x % Q, (x, got)


def test_shoup_lazy_bound_and_value():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2 * Q, 5000).astype(np.uint32)
    y = rng.integers(0, Q, 5000).astype(np.uint32)
    yq = ((y.astype(object) << 32) // Q).astype(np.uint64).astype(np.uint32)
    got = np.asarray(jax.jit(partial(ma.mul_mod_shoup_lazy, q=Q))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(yq)))
    want = (x.astype(np.uint64) * y.astype(np.uint64)) % Q
    assert (got < 2 * Q).all()
    assert ((got % Q) == want).all()


@pytest.mark.parametrize("q", P.moduli)
def test_ntt_bit_exact(q):
    rng = np.random.default_rng(q)
    x = rng.integers(0, q, (2, N)).astype(np.uint32)
    got = np.asarray(jax.jit(partial(tntt.ntt, q=q))(jnp.asarray(x)))
    for b in range(2):
        want = ntt_inpl(x[b].tolist(), N, LOGN, q, P.ntt_root(q))
        assert got[b].tolist() == want


def test_ntt_intt_roundtrip_jnp():
    rng = np.random.default_rng(9)
    x = rng.integers(0, Q, (3, N)).astype(np.uint32)
    y = jax.jit(lambda v: tntt.intt(tntt.ntt(v, Q), Q))(jnp.asarray(x))
    assert np.array_equal(np.asarray(y), x)


def _c64(nc, i):
    """Compose a u64 from a (..., 2) (lo, hi) counter pair row."""
    nc = np.asarray(nc)
    return int(nc[i, 0]) | (int(nc[i, 1]) << 32)


def test_keccak_vs_hashlib():
    seed = bytes(range(64))
    sw = jnp.asarray(kc.seed_to_words(seed))
    counters = jnp.asarray(np.array([[0, 0], [7, 0]], dtype=np.uint32))
    out = np.asarray(jax.jit(partial(kc.shake256_words, nblocks=2))(sw, counters))
    for i, c in enumerate([0, 7]):
        want = hashlib.shake_256(seed + c.to_bytes(8, "little")).digest(272)
        assert kc.words_to_bytes_np(out[i]) == want


def test_uniform_sampler_bit_exact():
    seed = bytes((7 + i) & 0xFF for i in range(64))
    sw = jnp.asarray(kc.seed_to_words(seed))
    f = jax.jit(partial(sp.sample_uniform, n=N, q=Q))
    poly, nc, ok = f(sw, sp.counter_zero((2,)))
    gp = Prng(seed)
    want = gs.sample_poly_uniform(N, Q, gp)
    assert bool(np.asarray(ok).all())
    assert np.asarray(poly)[0].tolist() == want
    assert _c64(nc, 0) == gp.counter
    # chained second call (next prime)
    want2 = gs.sample_poly_uniform(N, Q, gp)
    poly2, nc2, _ = f(sw, nc)
    assert np.asarray(poly2)[0].tolist() == want2
    assert _c64(nc2, 0) == gp.counter


def test_ternary_sampler_bit_exact():
    seed = bytes((5 + i) & 0xFF for i in range(64))
    sw = jnp.asarray(kc.seed_to_words(seed))
    f = jax.jit(partial(sp.sample_ternary, n=N))
    s, nc, ok = f(sw, sp.counter_zero((2,)))
    gp = Prng(seed)
    want = gs.ternary_signed(gs.sample_small_poly_ternary_96(N, gp), N)
    assert bool(np.asarray(ok).all())
    assert np.asarray(s)[0].tolist() == want
    assert _c64(nc, 0) == gp.counter


def test_cbd_sampler_bit_exact():
    seed = bytes((9 + i) & 0xFF for i in range(64))
    sw = jnp.asarray(kc.seed_to_words(seed))
    f = jax.jit(partial(sp.sample_cbd, n=N))
    e, nc = f(sw, sp.counter_zero((2,)))
    gp = Prng(seed)
    want = gs.sample_poly_cbd_16(N, gp)
    assert np.asarray(e)[0].tolist() == want
    assert _c64(nc, 0) == gp.counter


def test_counter_crosses_u32_boundary():
    """u64 counter pairs: a stream whose counter starts just below 2^32
    carries into the hi word exactly like the reference's uint64
    (rng.h:78-91); values and final counter match the golden model."""
    seed = bytes((3 + i) & 0xFF for i in range(64))
    sw = jnp.asarray(kc.seed_to_words(seed))
    start = 2 ** 32 - 2
    ctr = jnp.asarray(np.array([[start & 0xFFFFFFFF, start >> 32]] * 2,
                               dtype=np.uint32))
    poly, nc, ok = jax.jit(partial(sp.sample_uniform, n=N, q=Q))(sw, ctr)
    gp = Prng(seed, counter=start)
    want = gs.sample_poly_uniform(N, Q, gp)
    assert bool(np.asarray(ok).all())
    assert np.asarray(poly)[0].tolist() == want
    assert _c64(nc, 0) == gp.counter
    assert np.asarray(nc)[0, 1] == 1  # crossed into the hi word
    # CBD crossing too (deterministic counters, no rejection).
    e, nc2 = jax.jit(partial(sp.sample_cbd, n=N))(sw, ctr)
    gp2 = Prng(seed, counter=start)
    assert np.asarray(e)[0].tolist() == gs.sample_poly_cbd_16(N, gp2)
    assert _c64(nc2, 0) == gp2.counter


def test_reseed_on_overflow():
    """API-layer mirror of rng.h:85-91: a wrapped stream gets fresh seed
    material and counter 0; unwrapped streams are untouched."""
    before = jnp.asarray(np.array([[0xFFFFFFFF, 0xFFFFFFFF], [5, 0]],
                                  dtype=np.uint32))
    after = jnp.asarray(np.array([[2, 0], [9, 0]], dtype=np.uint32))
    wrapped = np.asarray(sp.counter_overflowed(before, after))
    assert wrapped.tolist() == [True, False]
    seeds = jnp.asarray(np.arange(32, dtype=np.uint32).reshape(2, 16))
    fresh = jnp.asarray(np.full((2, 16), 77, dtype=np.uint32))
    s2, c2, w = sp.reseed_on_overflow(seeds, before, after, fresh)
    assert np.asarray(w).tolist() == [True, False]
    assert np.asarray(s2)[0].tolist() == [77] * 16
    assert np.asarray(s2)[1].tolist() == list(range(16, 32))
    assert np.asarray(c2)[0].tolist() == [0, 0]
    assert np.asarray(c2)[1].tolist() == [9, 0]


def test_ntt_otf_matches_table_mode():
    """OTF-roots NTT (in-graph root synthesis + non-lazy Barrett
    butterflies, SE_NTT_TYPE 0 analog ntt.c:124-165) is value-identical
    to the table-mode NTT."""
    from seal_embedded_jax.ops.ntt import ntt, ntt_otf
    from seal_embedded_jax.config import PRIMES_30BIT

    rng = np.random.default_rng(21)
    for n, q in ((512, Q), (4096, PRIMES_30BIT[0])):
        x = jnp.asarray(rng.integers(0, q, (3, n)).astype(np.uint32))
        got = np.asarray(jax.jit(partial(ntt_otf, q=q))(x))
        want = np.asarray(jax.jit(partial(ntt, q=q))(x))
        assert np.array_equal(got, want), (n, q)


def test_counter_from_int_u64():
    c = sp.counter_from_int((3,), (7 << 32) | 5)
    assert np.asarray(c).shape == (3, 2)
    assert np.asarray(c)[0].tolist() == [5, 7]
    # offsets carry across the boundary
    nc = np.asarray(sp._c_add(c, jnp.uint32(0xFFFFFFFB)))
    assert nc[0].tolist() == [0, 8]
