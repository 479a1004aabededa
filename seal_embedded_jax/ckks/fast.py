"""Fused symmetric pipeline: the encrypt path of every backend.

Same math and same bit-exact reference semantics as ckks.limbwise
(layout="reference": one shareable PRNG stream whose counter chains
sequentially across primes, seal_embedded.c:145-213), but restructured so
the batch-wide work leaves the limb scan:

* all per-limb NTTs of the (batched) plaintext+error run as one vmapped
  table-driven NTT over (L, B, n) data — the NTT of pte is independent
  of the per-limb sampling, so it needs no place inside the limb scan;
* every SHAKE-256 expansion (uniform base + rejection queue, CBD) goes
  through ops.keccak, which runs the squeeze kernel on a GPU;
* the limb scan carries only the sampler counter (the one true sequential
  dependency) plus cheap elementwise modular ops.

Bit-identical to ckks.limbwise.sym_encrypt_limbscan(layout="reference")
(tests/test_fast.py) and to the C-reference golden vectors, with the
squeeze kernel forced on in interpret mode (tests/test_keccak_kernel.py).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Parms
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import encode_any
from ..ops.ntt import ntt, ntt_tables_stacked, ntt_with_tables


def _ntt_all_limbs(x_lbn, moduli):
    """(L, B, n) u32 -> per-limb forward NTT (vmapped over the limb axis,
    one table set per limb)."""
    n = x_lbn.shape[-1]
    op, quot = ntt_tables_stacked(n, moduli)
    qs = jnp.asarray(np.array(moduli, np.uint32))
    return jax.vmap(ntt_with_tables)(x_lbn, jnp.asarray(op),
                                     jnp.asarray(quot), qs)


def _mods_bcast(parms: Parms):
    """Mod of (L, 1, 1) arrays for broadcasting against (L, B, n) data."""
    m = ma.modpack(parms.moduli)
    return ma.Mod(*(jnp.asarray(f)[:, None, None] for f in m))


def sym_encrypt_fused(values, sk_signed, share_words, err_words,
                      parms: Parms, encode_mode: str = "dd"):
    """Batched symmetric encode+encrypt, reference PRNG semantics.

    values: f32 (B, <= n/2); sk_signed: i32 (n,) in {-1,0,1};
    share/err_words: u32 (B, 16) PRNG seeds.
    Returns dict with c0/c1 u32 (L, B, n), pte i64 (B, n), ok (B,).
    """
    B = values.shape[0]
    n = parms.degree
    L = parms.nprimes
    moduli = tuple(int(q) for q in parms.moduli)

    # --- encode + error (ckks_encode_base + ckks_sym_init) ---
    mods_b = _mods_bcast(parms)
    pt, ok_encode = encode_any(values, parms, encode_mode)
    e, _ = sp.sample_cbd(err_words, sp.counter_zero((B,)), n)
    pte = pt + e.astype(jnp.int64)
    pte_red = ma.reduce_pte_i64(pte[None], mods_b)          # (L, B, n) u32
    ntt_pte = _ntt_all_limbs(pte_red, moduli)               # (L, B, n)

    # --- NTT(s) per limb: (L, n), tiny (batch-independent) ---
    ntt_s = jnp.stack([
        ntt(jnp.where(sk_signed < 0, jnp.uint32(q - 1),
                      sk_signed.astype(jnp.uint32)), q)
        for q in moduli
    ])                                                      # (L, n)

    # --- limb scan: uniform a per prime, counter chains (bit-exact) ---
    mods = ma.Mod(*(jnp.asarray(f) for f in ma.modpack(parms.moduli)))

    def step(carry, mod):
        counter, ok = carry
        a, counter, ok_u = sp.sample_uniform(
            share_words, counter, n, mod,
            queue_cap=sp.queue_cap_for(n, parms.moduli))
        return (counter, ok & ok_u), a

    (counter, ok), a = jax.lax.scan(
        step, (sp.counter_zero((B,)), ok_encode), mods, length=L)

    # --- c0 = -a * ntt(s) + ntt(pte) mod q, all limbs at once ---
    c0 = _combine_c0(a, ntt_s, ntt_pte, mods_b)
    return {"c0": c0, "c1": a, "pte": pte, "pt": pt, "ok": ok}


def _combine_c0(a, ntt_s, ntt_pte, mods_b):
    """c0 = add_mod(neg_mod(mul_mod(a, ntt_s)), ntt(pte)), all limbs."""
    as_ = ma.mul_mod(a, ntt_s[:, None, :], mods_b)
    return ma.add_mod(ma.neg_mod(as_, mods_b), ntt_pte, mods_b)


@lru_cache(maxsize=16)
def make_fused_encryptor(parms: Parms, encode_mode: str = "dd"):
    return jax.jit(partial(sym_encrypt_fused, parms=parms,
                           encode_mode=encode_mode))
