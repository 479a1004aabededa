"""Limb-scan / limb-parallel symmetric pipeline.

Two stream layouts:

* "reference" — the reference's exact PRNG semantics: one shareable stream
  whose counter chains *sequentially* across primes (rejection re-draws of
  prime i shift prime i+1's counters; seal_embedded.c:145-213).  Expressed
  as lax.scan over the limb axis with the counter as carry: bit-exact, and
  the Keccak/NTT bodies are traced once instead of once per prime
  (nprimes-fold smaller XLA graph than the unrolled path).

* "parallel" — a limb-parallel layout: prime i's uniform stream starts at
  counter i * PARALLEL_COUNTER_STRIDE, decoupling the limbs entirely so the
  limb axis vectorizes/shards with no sequential dependency.  Ciphertexts
  are equally valid RLWE samples and decrypt identically under SEAL (the
  full c1 is transmitted), but are not byte-identical to the reference's
  single-stream vectors.  Choose per call.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Parms
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import encode
from ..ops.keccak import align_seed
from ..ops.ntt import ntt_tables_stacked, ntt_with_tables

PARALLEL_COUNTER_STRIDE = 1 << 20


def _limb_stack(parms: Parms):
    """Per-limb constants: Mod arrays (L,) + NTT tables (L, n)."""
    mods = ma.modpack(parms.moduli)
    op, quot = ntt_tables_stacked(parms.degree, parms.moduli)
    return mods, jnp.asarray(op), jnp.asarray(quot)


def _one_prime(pte, sk_signed, share_words, counter, mod: ma.Mod, op, quot,
               n: int, qcap: int | None = None):
    """c0, c1 for one prime given traced per-limb constants."""
    a, counter, ok = sp.sample_uniform(share_words, counter, n, mod,
                                       queue_cap=qcap)
    s_modq = jnp.where(sk_signed < 0, mod.q - 1,
                       sk_signed.astype(jnp.uint32)).astype(jnp.uint32)
    ntt_s = ntt_with_tables(s_modq, op, quot, mod)
    c0 = ma.neg_mod(ma.mul_mod(a, ntt_s[None, :], mod), mod)
    pte_red = ma.reduce_pte_i64(pte, mod)
    ntt_pte = ntt_with_tables(pte_red, op, quot, mod)
    c0 = ma.add_mod(c0, ntt_pte, mod)
    return c0, a, counter, ok


def sym_encrypt_from_pte(pte, sk_signed, share_words, parms: Parms,
                         layout: str = "reference", ok_in=None,
                         order: str = "forward"):
    """Integer-only symmetric encrypt from an already-encoded pte (i64).

    Combined with any bit-exact encode it yields bit-exact ciphertexts.

    order: 'forward' walks the modulus chain 0..L-1; 'reverse' walks it
    L-1..0 — the reference's SE_REVERSE_CT_GEN direction for every other
    message (parameters.c:52-89, a table-reload optimization there; here
    pure capability parity).  Outputs are stacked in walk order.
    """
    B = pte.shape[0]
    n = parms.degree
    L = parms.nprimes
    mods, op, quot = _limb_stack(parms)
    if order == "reverse":
        mods = ma.Mod(*(f[::-1] for f in mods))
        op, quot = op[::-1], quot[::-1]
    elif order != "forward":
        raise ValueError(f"unknown order {order!r}")
    mods = ma.Mod(*(jnp.asarray(f) for f in mods))
    ok_encode = ok_in if ok_in is not None else jnp.ones((B,), bool)
    qcap = sp.queue_cap_for(n, parms.moduli)

    if layout == "reference":
        def step(carry, limb):
            counter, ok = carry
            mod, op_l, quot_l = limb
            c0, c1, counter, ok_u = _one_prime(
                pte, sk_signed, share_words, counter, mod, op_l, quot_l, n,
                qcap)
            return (counter, ok & ok_u), (c0, c1)

        (counter, ok), (c0, c1) = jax.lax.scan(
            step, (sp.counter_zero((B,)), ok_encode),
            (mods, op, quot), length=L)
    elif layout == "parallel":
        # Strided counters decouple limbs; vmap the limb axis.
        counters = jnp.stack(
            [jnp.arange(L, dtype=jnp.uint32)
             * jnp.uint32(PARALLEL_COUNTER_STRIDE),
             jnp.zeros((L,), jnp.uint32)], axis=-1)

        def limb_fn(mod, op_l, quot_l, counter0):
            counter = jnp.broadcast_to(counter0, (B, 2))
            c0, c1, counter, ok_u = _one_prime(
                pte, sk_signed, share_words, counter, mod, op_l, quot_l, n,
                qcap)
            return c0, c1, ok_u

        c0, c1, ok_u = jax.vmap(limb_fn)(mods, op, quot, counters)
        ok = ok_encode & ok_u.all(axis=0)
    else:
        raise ValueError(f"unknown layout {layout!r}")

    return {"c0": c0, "c1": c1, "pte": pte, "ok": ok}


def sym_encrypt_limbscan(values, sk_signed, share_words, err_words,
                         parms: Parms, layout: str = "reference",
                         encode_mode: str = "f64", order: str = "forward"):
    """Batched symmetric encode+encrypt: on-device encode + CBD error, then
    the integer limb pipeline."""
    from ..ops.encode import encode_any
    B = values.shape[0]
    n = parms.degree
    pt, ok_encode = encode_any(values, parms, encode_mode)
    e, _ = sp.sample_cbd(err_words, sp.counter_zero((B,)), n)
    pte = pt + e.astype(jnp.int64)
    out = sym_encrypt_from_pte(pte, sk_signed, share_words, parms,
                               layout=layout, ok_in=ok_encode, order=order)
    out["pt"] = pt
    return out


def expand_c1(share_words, parms: Parms, layout: str = "reference",
              order: str = "forward"):
    """Regenerate the c1 components from the 64-byte shareable seed — the
    receiver half of seed-expandable symmetric ciphertexts (the
    SE_ENABLE_SYM_SEED_CT capability the reference declares but leaves
    unfinished, seal_embedded.c:184-194; seed-size compatibility with
    SEAL's compressed cts is why seeds are 64 bytes, defines.h:62-67).

    share_words: u32 (B, 16).  Returns (c1 u32 (L, B, n), ok (B,)) with
    the exact per-prime counter chaining of the encryptor.
    """
    B = share_words.shape[0]
    n = parms.degree
    L = parms.nprimes
    mods = ma.modpack(parms.moduli)
    if order == "reverse":
        mods = ma.Mod(*(f[::-1] for f in mods))
    mods = ma.Mod(*(jnp.asarray(f) for f in mods))

    if layout == "reference":
        def step(carry, mod):
            counter, ok = carry
            a, counter, ok_u = sp.sample_uniform(share_words, counter, n, mod)
            return (counter, ok & ok_u), a

        (_, ok), c1 = jax.lax.scan(
            step, (sp.counter_zero((B,)), jnp.ones((B,), bool)),
            mods, length=L)
    elif layout == "parallel":
        counters = jnp.stack(
            [jnp.arange(L, dtype=jnp.uint32)
             * jnp.uint32(PARALLEL_COUNTER_STRIDE),
             jnp.zeros((L,), jnp.uint32)], axis=-1)

        def limb_fn(mod, counter0):
            counter = jnp.broadcast_to(counter0, (B, 2))
            a, _, ok_u = sp.sample_uniform(share_words, counter, n, mod,
                                           queue_cap=qcap)
            return a, ok_u

        c1, ok_u = jax.vmap(limb_fn)(mods, counters)
        ok = ok_u.all(axis=0)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return c1, ok


@lru_cache(maxsize=16)
def make_c1_expander(parms: Parms, layout: str = "reference",
                     order: str = "forward"):
    return jax.jit(partial(expand_c1, parms=parms, layout=layout,
                           order=order))


def add_cbd_error(pt, err_words, n: int):
    """pt + CBD error with counter 0 (ckks_sym_init, ckks_sym.c:181-197);
    exposed for the host-encode bit-exact path."""
    e, _ = sp.sample_cbd(err_words, jnp.zeros((pt.shape[0],), jnp.uint32), n)
    return pt + e.astype(jnp.int64)


@lru_cache(maxsize=16)
def make_limbscan_encryptor(parms: Parms, layout: str = "reference",
                            encode_mode: str = "f64",
                            order: str = "forward"):
    return jax.jit(partial(sym_encrypt_limbscan, parms=parms, layout=layout,
                           encode_mode=encode_mode, order=order))


@lru_cache(maxsize=16)
def make_from_pte_encryptor(parms: Parms, layout: str = "reference"):
    return jax.jit(partial(sym_encrypt_from_pte, parms=parms, layout=layout))
