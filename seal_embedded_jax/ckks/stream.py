"""Per-prime streaming encryption — the reference's core operating mode.

The reference generates and transmits ONE ciphertext RNS component at a
time (seal_embedded.c:145-213: encrypt prime i, send c0/c1, advance the
modulus), bounding device memory at O(n) instead of O(L*n).  The batched
equivalent: a host-level pipeline over the modulus chain where each limb
is one jit-compiled step (counter carried between steps), and the host
fetches/sends limb i's components while the device computes limb i+1 —
the PP axis of SURVEY.md S2.3 (double-buffered dispatch: JAX's async
dispatch queue overlaps the device compute with the host-side send).

Bit-exact with the limb-scan pipeline (same sampler counter chaining).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Parms
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import encode_any
from ..ops.ntt import ntt_tables, ntt_with_tables


@lru_cache(maxsize=16)
def _limb_step(parms: Parms):
    """jit step: (pte, sk, share_words, counter, limb constants) -> limb ct.

    One compiled graph serves every limb: the modulus and root tables ride
    as data (u32 arrays), exactly like the limb-scan body.
    """
    n = parms.degree

    def step(pte, sk_signed, share_words, counter, mod, op, quot):
        a, counter, ok = sp.sample_uniform(
            share_words, counter, n, mod,
            queue_cap=sp.queue_cap_for(n, parms.moduli))
        s_modq = sp.ternary_to_modq_any(sk_signed, mod)
        ntt_s = ntt_with_tables(s_modq, op, quot, mod)
        c0 = ma.neg_mod(ma.mul_mod(a, ntt_s[None, :], mod), mod)
        pte_red = ma.reduce_pte_i64(pte, mod)
        ntt_pte = ntt_with_tables(pte_red, op, quot, mod)
        c0 = ma.add_mod(c0, ntt_pte, mod)
        return c0, a, counter, ok

    return jax.jit(step)


@lru_cache(maxsize=16)
def _encode_err(parms: Parms, encode_mode: str):
    def f(values, err_words):
        pt, ok = encode_any(values, parms, encode_mode)
        e, _ = sp.sample_cbd(err_words, sp.counter_zero((values.shape[0],)),
                             parms.degree)
        return pt + e.astype(jnp.int64), ok

    return jax.jit(f)


def sym_encrypt_stream(values, sk_signed, share_words, err_words,
                       parms: Parms, encode_mode: str = "f64",
                       order: str = "forward") -> Iterator[dict]:
    """Yields one dict per prime, in chain-walk order:
    {"prime_idx", "q", "c0", "c1", "ok"} with c0/c1 u32 (B, n) numpy
    arrays; "ok" folds the encode overflow flag (re-asserted at every
    yielded limb) with that limb's sampler-queue flag — both assert
    here AND surface in the dict for sweep/driver bookkeeping.

    The device runs ahead: limb i+1's dispatch is queued before limb i's
    components are fetched, so host-side send overlaps device compute.
    """
    step = _limb_step(parms)
    pte, ok_enc = _encode_err(parms, encode_mode)(values, err_words)

    idxs = list(range(parms.nprimes))
    if order == "reverse":
        idxs = idxs[::-1]

    B = values.shape[0]
    counter = sp.counter_zero((B,))
    pending = []  # (prime_idx, q, c0, c1, ok) device arrays, queue depth 1
    for i in idxs:
        q = int(parms.moduli[i])
        mod = ma.as_mod(q)
        mod = ma.Mod(*(jnp.asarray(f) for f in mod))
        op, quot = ntt_tables(parms.degree, q)
        c0, c1, counter, ok_u = step(pte, sk_signed, share_words, counter,
                                     mod, jnp.asarray(op), jnp.asarray(quot))
        pending.append((i, q, c0, c1, ok_u & ok_enc))
        if len(pending) > 1:
            yield _fetch(pending.pop(0))
    while pending:
        yield _fetch(pending.pop(0))


def _fetch(item):
    i, q, c0, c1, ok = item
    ok = bool(np.asarray(ok).all())
    assert ok, f"sampler overflow or encode overflow at prime {i}"
    return {"prime_idx": i, "q": q, "c0": np.asarray(c0),
            "c1": np.asarray(c1), "ok": ok}


@lru_cache(maxsize=16)
def _limb_step_asym(parms: Parms):
    """jit step for one asym limb: pure arithmetic, no PRNG state — the
    reference streams asym exactly like sym (seal_embedded.c:145-213 with
    ckks_next_prime_asym, ckks_asym.c:205-288), and all sampling happens
    once up front (ckks_asym_init), so each limb is independent."""
    from ..ops.sampling import ternary_to_modq_any

    def step(pte, u_signed, e1, pk0_l, pk1_l, mod, op, quot):
        ntt_u = ntt_with_tables(ternary_to_modq_any(u_signed, mod),
                                op, quot, mod)
        c1 = ma.mul_mod(pk1_l[None, :], ntt_u, mod)
        c0 = ma.mul_mod(pk0_l[None, :], ntt_u, mod)
        e1_red = jnp.where(e1 < 0, (e1 + mod.q.astype(jnp.int32))
                           .astype(jnp.uint32), e1.astype(jnp.uint32))
        c1 = ma.add_mod(c1, ntt_with_tables(e1_red, op, quot, mod), mod)
        pte_red = ma.reduce_pte_i64(pte, mod)
        c0 = ma.add_mod(c0, ntt_with_tables(pte_red, op, quot, mod), mod)
        return c0, c1

    return jax.jit(step)


@lru_cache(maxsize=16)
def _asym_init(parms: Parms, encode_mode: str):
    """jit of the up-front asym phase (encode + u/e0/e1 sampling,
    ckks_asym_init semantics: one private stream, counters chaining
    u -> e0 -> e1)."""
    n = parms.degree

    def f(values, seed_words):
        pt, ok = encode_any(values, parms, encode_mode)
        counter = sp.counter_zero((values.shape[0],))
        u_signed, counter, ok_t = sp.sample_ternary(seed_words, counter, n)
        e0, counter = sp.sample_cbd(seed_words, counter, n)
        e1, _ = sp.sample_cbd(seed_words, counter, n)
        return pt + e0.astype(jnp.int64), u_signed, e1, ok & ok_t

    return jax.jit(f)


def asym_encrypt_stream(values, pk0, pk1, seed_words, parms: Parms,
                        encode_mode: str = "f64",
                        order: str = "forward") -> Iterator[dict]:
    """Per-prime streaming asymmetric encrypt; same contract as
    sym_encrypt_stream (one dict per prime in chain-walk order, device
    runs one limb ahead of the host fetch).  pk0/pk1: u32 (L, n) NTT
    form."""
    step = _limb_step_asym(parms)
    pte, u_signed, e1, ok = _asym_init(parms, encode_mode)(values, seed_words)

    idxs = list(range(parms.nprimes))
    if order == "reverse":
        idxs = idxs[::-1]

    pending = []
    for i in idxs:
        q = int(parms.moduli[i])
        mod = ma.Mod(*(jnp.asarray(f) for f in ma.as_mod(q)))
        op, quot = ntt_tables(parms.degree, q)
        c0, c1 = step(pte, u_signed, e1, pk0[i], pk1[i], mod,
                      jnp.asarray(op), jnp.asarray(quot))
        pending.append((i, q, c0, c1, ok))
        if len(pending) > 1:
            yield _fetch(pending.pop(0))
    while pending:
        yield _fetch(pending.pop(0))


def se_encrypt_streaming(ctx, values, share_seeds=None, err_seeds=None,
                         send: Optional[Callable[[bytes], int]] = None,
                         order: str = "forward"):
    """API-level streaming encrypt: send c0/c1 bytes per prime as produced
    (the reference's send-per-prime loop, seal_embedded.c:180-204).

    Symmetric contexts stream via sym_encrypt_stream (share_seeds = the
    shareable stream, err_seeds = the private stream); asymmetric contexts
    via asym_encrypt_stream (err_seeds = the private stream sampling
    u/e0/e1; share_seeds unused)."""
    from ..api import _seed_words_batch
    from ..io import serialize

    values = np.atleast_2d(np.asarray(values, dtype=np.float32))
    if ctx.encrypt_type == "asym":
        assert ctx.pk0 is not None, "asym streaming needs a loaded pk"
        gen = asym_encrypt_stream(
            jnp.asarray(values), jnp.asarray(ctx.pk0), jnp.asarray(ctx.pk1),
            _seed_words_batch(err_seeds), ctx.parms,
            ctx.resolved_encode_mode(), order)
    else:
        gen = sym_encrypt_stream(
            jnp.asarray(values), jnp.asarray(ctx.sk_signed),
            _seed_words_batch(share_seeds), _seed_words_batch(err_seeds),
            ctx.parms, ctx.resolved_encode_mode(), order)
    out = []
    for limb in gen:
        if send is not None:
            for b in range(values.shape[0]):
                send(serialize.ct_component_bytes(limb["c0"][b]))
                send(serialize.ct_component_bytes(limb["c1"][b]))
        out.append(limb)
    return out
