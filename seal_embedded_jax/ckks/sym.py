"""Batched symmetric CKKS encode+encrypt pipeline (prime loop unrolled).

The reference hot path (seal_embedded.c:98-215 -> ckks_sym.c:181-301)
re-designed as one jit-compiled batched graph:

    encode (IFFT f64)  ->  + CBD error  ->  per prime:
        a = uniform(shareable stream)      [c1]
        c0 = -a * ntt(s) + ntt(reduce(pt + e))

Batch axis = independent messages, each with its own (share_seed, err_seed)
PRNG stream pair; the secret key is shared across the batch (the reference's
device model).  All integer arithmetic is exact on every backend; with a
bit-exact f64 encode the whole pipeline is bit-exact against the C
reference (validated in tests/test_pipeline.py against golden vectors).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Parms
from ..ops import keccak as kc
from ..ops import modarith as ma
from ..ops import sampling as sp
from ..ops.encode import encode
from ..ops.ntt import ntt, ntt_otf


def _ntt_s_for_prime(sk_signed, q: int):
    """ntt(expand(s)) for one prime; sk_signed {-1,0,1} (..., n)."""
    s_modq = sp.ternary_to_modq(sk_signed, q)
    return ntt(s_modq, q)


def sym_encrypt_batch(values, sk_signed, share_seed_words, err_seed_words,
                      parms: Parms, ntt_variant: str = "table",
                      root_tables=None, imap=None):
    """Full batched symmetric encode+encrypt.

    values:            f32 (B, <= n/2)
    sk_signed:         i32 (n,) ternary secret key in {-1, 0, 1}
    share_seed_words:  u32 (B, 16) per-message shareable seeds
    err_seed_words:    u32 (B, 16) per-message error seeds
    ntt_variant:       "table" (precomputed Shoup tables, SE_NTT_TYPE 2/3
                       analog) or "otf" (roots synthesized in-graph,
                       SE_NTT_TYPE 0/1 analog — value-identical cts)
    root_tables/imap:  optional LOADED ifft root tables / index map
                       (SE_IFFT_LOAD_FULL / SE_INDEX_MAP_LOAD data paths,
                       fileops.c:208-255), forwarded to encode()
    Returns dict with c0, c1: u32 (nprimes, B, n), pt, pte: i64 (B, n),
    ok: bool (B,).
    """
    B = values.shape[0]
    n = parms.degree
    do_ntt = {"table": ntt, "otf": ntt_otf}[ntt_variant]

    pt, ok_encode = encode(values, parms, root_tables=root_tables, imap=imap)

    err_counter = sp.counter_zero((B,))
    e, _ = sp.sample_cbd(err_seed_words, err_counter, n)
    pte = pt + e.astype(jnp.int64)

    share_counter = sp.counter_zero((B,))
    ok = ok_encode
    c0_list, c1_list = [], []
    for q in parms.moduli:
        a, share_counter, ok_u = sp.sample_uniform(
            share_seed_words, share_counter, n, q,
            queue_cap=sp.queue_cap_for(n, parms.moduli))
        s_modq = sp.ternary_to_modq(sk_signed, q)
        ntt_s = do_ntt(s_modq, q)                       # (n,)
        as_ = ma.mul_mod(a, ntt_s[None, :], q)          # a * ntt(s)
        c0 = ma.neg_mod(as_, q)
        pte_red = ma.reduce_pte_i64(pte, q)
        ntt_pte = do_ntt(pte_red, q)
        c0 = ma.add_mod(c0, ntt_pte, q)
        c0_list.append(c0)
        c1_list.append(a)
        ok = ok & ok_u

    return {
        "c0": jnp.stack(c0_list),
        "c1": jnp.stack(c1_list),
        "pt": pt,
        "pte": pte,
        "ok": ok,
    }


from functools import lru_cache


@lru_cache(maxsize=16)
def make_sym_encryptor(parms: Parms, layout: str = "reference"):
    """Cached jit-compiled symmetric encryptor.

    Uses the limb-scan pipeline (ckks/limbwise.py): bit-identical to
    sym_encrypt_batch in "reference" layout, with an nprimes-fold smaller
    compiled graph.
    """
    from .limbwise import sym_encrypt_limbscan
    return jax.jit(partial(sym_encrypt_limbscan, parms=parms, layout=layout))


@lru_cache(maxsize=16)
def make_decryptor(parms: Parms):
    return jax.jit(partial(decrypt_batch, parms=parms))


def decrypt_batch(c0, c1, sk_signed, parms: Parms,
                  intt_impl: str = "canonical", loaded_intt=None):
    """Test oracle: per-prime decrypt to centered pte (i64 (nprimes, B, n)).

    c0/c1: u32 (nprimes, B, n).  intt_impl: 'canonical' (ops.ntt.intt) or
    'lazy' — the reference's fast INTT with MUMO tables
    (intt_lazy_inpl, intt.c:72-129), consuming `loaded_intt` ({q: (op,
    quot)} arrays, e.g. from intt_fast_roots_<n>_<q>.dat files) or
    computing the tables in the same file order.  Value-identical.
    """
    from ..io.serialize import intt_fast_root_table
    from ..ops.ntt import intt, intt_lazy_with_tables
    outs = []
    for i, q in enumerate(parms.moduli):
        q = int(q)
        ntt_s = _ntt_s_for_prime(sk_signed, q)
        pte_ntt = ma.add_mod(c0[i], ma.mul_mod(c1[i], ntt_s[None, :], q), q)
        if intt_impl == "lazy":
            if loaded_intt is not None and q in loaded_intt:
                op, quot = loaded_intt[q]
            else:
                pairs = intt_fast_root_table(
                    parms.degree, parms.logn, q, parms.ntt_root(q))
                op, quot = pairs[0::2], pairs[1::2]
            pte = intt_lazy_with_tables(
                pte_ntt, jnp.asarray(np.asarray(op, np.uint32)),
                jnp.asarray(np.asarray(quot, np.uint32)), q)
        else:
            pte = intt(pte_ntt, q)
        centered = jnp.where(pte > q // 2, pte.astype(jnp.int64) - q,
                             pte.astype(jnp.int64))
        outs.append(centered)
    return jnp.stack(outs)
