"""Batched asymmetric (public-key) CKKS encode+encrypt pipeline.

Reference flow (seal_embedded.c asym path, ckks_asym.c:159-286):
    u <- ternary;  pte = pt + e0;  e1 <- CBD       (one private PRNG stream)
    per prime: c1 = pk1 * ntt(u) + ntt(e1)
               c0 = pk0 * ntt(u) + ntt(pte)
plus device-side public-key generation (gen_pk = symmetric encryption of
zero with explicit ep, ckks_asym.c:159-171).

Design: unlike the symmetric path, the asymmetric per-prime work has
NO sequential dependency (all sampling happens once up front from the
private stream; the per-prime loop is pure arithmetic, ckks_asym.c:205-286).
The limb axis therefore vmaps: the three NTTs (u, e1, pte) trace once and
batch over (limb, message).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Parms
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import encode, encode_any
from ..ops.ntt import ntt, ntt_tables_stacked, ntt_with_tables


def _limb_consts(parms: Parms):
    mods = ma.Mod(*(jnp.asarray(f) for f in ma.modpack(parms.moduli)))
    op, quot = ntt_tables_stacked(parms.degree, parms.moduli)
    return mods, jnp.asarray(op), jnp.asarray(quot)


def _signed_to_modq(x, q):
    """Small signed values {-k..k} -> [0, q) (poly with negatives folded)."""
    qv = jnp.asarray(ma._q(q)).astype(jnp.uint32)
    return jnp.where(x < 0, (x + qv.astype(jnp.int32)).astype(jnp.uint32),
                     x.astype(jnp.uint32))


def gen_pk_batch(sk_signed, pk_seed_words, ep, parms: Parms):
    """Device-side pk generation (ckks_asym.c:159-171).

    sk_signed: i32 (n,); pk_seed_words: u32 (16,) or (1, 16);
    ep: i32 (n,) CBD error.  Returns (pk0, pk1): u32 (nprimes, n).

    The shareable stream's counter chains across primes exactly like the
    symmetric encryptor's (one uniform draw of `a` per prime), so this is
    a lax.scan over the limb axis.
    """
    n = parms.degree
    mods, op, quot = _limb_consts(parms)
    qcap = sp.queue_cap_for(n, parms.moduli)

    def step(counter, limb):
        mod, op_l, quot_l = limb
        a, counter, _ = sp.sample_uniform(pk_seed_words, counter, n, mod,
                                          queue_cap=qcap)
        a = a[0]
        s_modq = sp.ternary_to_modq_any(sk_signed, mod)
        ntt_s = ntt_with_tables(s_modq, op_l, quot_l, mod)
        pk0 = ma.neg_mod(ma.mul_mod(a, ntt_s, mod), mod)
        ep_red = _signed_to_modq(ep, mod)
        pk0 = ma.add_mod(pk0, ntt_with_tables(ep_red, op_l, quot_l, mod), mod)
        return counter, (pk0, a)

    _, (pk0, pk1) = jax.lax.scan(step, sp.counter_zero((1,)),
                                 (mods, op, quot), length=parms.nprimes)
    return pk0, pk1


def asym_encrypt_batch(values, pk0, pk1, seed_words, parms: Parms,
                       encode_mode: str = "f64"):
    """Full batched asymmetric encode+encrypt.

    values:     f32 (B, <= n/2)
    pk0, pk1:   u32 (nprimes, n) public key, NTT form
    seed_words: u32 (B, 16) per-message private seeds
    Returns dict with c0, c1 u32 (nprimes, B, n), ok (B,).
    """
    B = values.shape[0]
    n = parms.degree

    pt, ok = encode_any(values, parms, encode_mode)

    # Private stream, counters chaining u -> e0 -> e1 (ckks_asym.c:173-203).
    counter = sp.counter_zero((B,))
    u_signed, counter, ok_t = sp.sample_ternary(seed_words, counter, n)
    e0, counter = sp.sample_cbd(seed_words, counter, n)
    e1, counter = sp.sample_cbd(seed_words, counter, n)
    pte = pt + e0.astype(jnp.int64)
    ok = ok & ok_t

    mods, op, quot = _limb_consts(parms)

    def limb_fn(mod, op_l, quot_l, pk0_l, pk1_l):
        u_modq = sp.ternary_to_modq_any(u_signed, mod)
        ntt_u = ntt_with_tables(u_modq, op_l, quot_l, mod)
        c1 = ma.mul_mod(pk1_l[None, :], ntt_u, mod)
        c0 = ma.mul_mod(pk0_l[None, :], ntt_u, mod)
        e1_red = _signed_to_modq(e1, mod)
        c1 = ma.add_mod(c1, ntt_with_tables(e1_red, op_l, quot_l, mod), mod)
        pte_red = ma.reduce_pte_i64(pte, mod)
        c0 = ma.add_mod(c0, ntt_with_tables(pte_red, op_l, quot_l, mod), mod)
        return c0, c1

    c0, c1 = jax.vmap(limb_fn)(mods, op, quot, pk0, pk1)
    return {"c0": c0, "c1": c1, "pt": pt, "pte": pte, "ok": ok}


def asym_encrypt_fused(values, pk0, pk1, seed_words, parms: Parms,
                       encode_mode: str = "dd"):
    """The public-key encrypt path: all 3*L NTTs (u, e1, pte per limb)
    run as one vmapped NTT over (L, 3B, n) data."""
    from .fast import _mods_bcast, _ntt_all_limbs

    B = values.shape[0]
    n = parms.degree
    L = parms.nprimes
    moduli = tuple(int(q) for q in parms.moduli)

    pt, ok = encode_any(values, parms, encode_mode)
    counter = sp.counter_zero((B,))
    u_signed, counter, ok_t = sp.sample_ternary(seed_words, counter, n)
    e0, counter = sp.sample_cbd(seed_words, counter, n)
    e1, counter = sp.sample_cbd(seed_words, counter, n)
    pte = pt + e0.astype(jnp.int64)
    ok = ok & ok_t

    mods_b = _mods_bcast(parms)  # (L,1,1) arrays
    u_lbn = sp.ternary_to_modq_any(u_signed[None], mods_b)
    u_lbn = jnp.broadcast_to(u_lbn, (L, B, n))
    e1_lbn = jnp.broadcast_to(_signed_to_modq(e1[None], mods_b), (L, B, n))
    pte_lbn = ma.reduce_pte_i64(pte[None], mods_b)

    # Stack the three polys along the BATCH axis, not the limb axis: the
    # per-limb modulus (and root table) is shared by u/e1/pte, so one
    # (L, 3B, n) NTT uses one table set per limb.
    stacked = jnp.concatenate([u_lbn, e1_lbn, pte_lbn], axis=1)  # (L, 3B, n)
    ntts = _ntt_all_limbs(stacked, moduli)
    ntt_u = ntts[:, :B]
    ntt_e1 = ntts[:, B:2 * B]
    ntt_pte = ntts[:, 2 * B:]

    c1 = ma.add_mod(ma.mul_mod(pk1[:, None, :], ntt_u, mods_b), ntt_e1,
                    mods_b)
    c0 = ma.add_mod(ma.mul_mod(pk0[:, None, :], ntt_u, mods_b), ntt_pte,
                    mods_b)
    return {"c0": c0, "c1": c1, "pt": pt, "pte": pte, "ok": ok}


@lru_cache(maxsize=16)
def make_asym_encryptor(parms: Parms, encode_mode: str = "f64"):
    return jax.jit(partial(asym_encrypt_batch, parms=parms,
                           encode_mode=encode_mode))


@lru_cache(maxsize=16)
def make_fused_asym_encryptor(parms: Parms, encode_mode: str = "dd"):
    return jax.jit(partial(asym_encrypt_fused, parms=parms,
                           encode_mode=encode_mode))
