"""Batched negacyclic NTT/INTT (jnp).

Re-design of the reference NTT (device/lib/ntt.c): instead of a scalar
butterfly loop, each of the log2(n) rounds is a vectorized pairwise op
over shape (..., h, 2, tt), batched over a leading ciphertext axis.  Uses the lazy Harvey accumulation in
[0, 4q) with Shoup (MUMO) root multiplication (ntt.c:72-109) and a final
correction to canonical [0, q) — bit-identical to the reference's output.

Root tables are precomputed host-side, exactly like the adapter generates
them (adapter/generate.cpp:253-445): table[i] = w^bitrev(i, logn) plus the
Shoup quotient word.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..config import barrett_quotient, bitrev, find_ntt_root
from .modarith import U32, mul_mod_shoup_lazy, mulhi, mullo, shift_result


@lru_cache(maxsize=64)
def ntt_tables(n: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """(operand, quotient) forward tables, bitrev-indexed (ntt.c:40-52)."""
    logn = n.bit_length() - 1
    w = find_ntt_root(n, q)
    op = np.zeros(n, dtype=np.uint32)
    quot = np.zeros(n, dtype=np.uint32)
    power = 1
    for i in range(n):
        idx = bitrev(i, logn)
        op[idx] = power
        quot[idx] = barrett_quotient(power, q) & 0xFFFFFFFF
        power = (power * w) % q
    return op, quot


@lru_cache(maxsize=64)
def intt_tables(n: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse-root tables, same indexing as forward (intt.c:511-605
    semantics)."""
    logn = n.bit_length() - 1
    w = find_ntt_root(n, q)
    winv = pow(w, q - 2, q)
    op = np.zeros(n, dtype=np.uint32)
    quot = np.zeros(n, dtype=np.uint32)
    power = 1
    for i in range(n):
        idx = bitrev(i, logn)
        op[idx] = power
        quot[idx] = barrett_quotient(power, q) & 0xFFFFFFFF
        power = (power * winv) % q
    return op, quot


def ntt(x, q: int):
    """Forward negacyclic NTT over the last axis, scrambled (bit-reversed)
    output order, canonical [0,q) output.  x: uint32 (..., n)."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    op_np, quot_np = ntt_tables(n, q)
    op = jnp.asarray(op_np)
    quot = jnp.asarray(quot_np)
    batch_shape = x.shape[:-1]
    v = x.astype(U32)
    two_q = 2 * q

    h, tt = 1, n // 2
    for _ in range(logn):
        v = v.reshape(batch_shape + (h, 2, tt))
        u = v[..., 0, :]
        w_ = v[..., 1, :]
        # Root for group j of this round: table[h + j] (ntt.c:89).
        s_op = op[h:2 * h].reshape((1,) * len(batch_shape) + (h, 1))
        s_quot = quot[h:2 * h].reshape((1,) * len(batch_shape) + (h, 1))
        # Harvey butterfly, values stay in [0, 4q) (ntt.c:93-106).
        u = jnp.where(u >= two_q, u - two_q, u)
        t = mul_mod_shoup_lazy(w_, s_op, s_quot, q)
        v = jnp.stack([u + t, u + two_q - t], axis=-2)
        h, tt = h * 2, tt // 2

    v = v.reshape(batch_shape + (n,))
    # Final correction [0,4q) -> [0,q) (ntt.c:171-185).
    v = jnp.where(v >= two_q, v - two_q, v)
    v = jnp.where(v >= q, v - q, v)
    return v.astype(U32)


def intt(x, q: int):
    """Inverse of ntt(): canonical [0,q) coefficients (intt.c semantics,
    including the 1/n fold)."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    op_np, quot_np = intt_tables(n, q)
    op = jnp.asarray(op_np)
    quot = jnp.asarray(quot_np)
    batch_shape = x.shape[:-1]
    v = x.astype(U32)

    h, tt = n // 2, 1
    for _ in range(logn):
        v = v.reshape(batch_shape + (h, 2, tt))
        u = v[..., 0, :]
        w_ = v[..., 1, :]
        s_op = op[h:2 * h].reshape((1,) * len(batch_shape) + (h, 1))
        s_quot = quot[h:2 * h].reshape((1,) * len(batch_shape) + (h, 1))
        add = shift_result((u + w_).astype(U32), q)
        diff = shift_result((u + q - w_).astype(U32), q)
        t = shift_result(mul_mod_shoup_lazy(diff, s_op, s_quot, q), q)
        v = jnp.stack([add, t], axis=-2)
        h, tt = h // 2, tt * 2

    v = v.reshape(batch_shape + (n,))
    ninv = pow(n, q - 2, q)
    nq = barrett_quotient(ninv, q) & 0xFFFFFFFF
    v = shift_result(
        mul_mod_shoup_lazy(v, jnp.asarray(ninv, U32), jnp.asarray(nq, U32), q), q
    )
    return v.astype(U32)


@lru_cache(maxsize=64)
def intt_lazy_consts(n: int, q: int) -> tuple[tuple, tuple]:
    """((inv_n, quot), (last_inv_sn, quot)) MUMO scalars for the lazy
    INTT's merged final round (intt.c:226-268: inv_n = n^-1 mod q,
    last_inv_sn = s * inv_n where s is the final round's root — the
    values the reference hard-codes per (n, q) and the adapter prints;
    verified against the worked example at intt.c:247-252)."""
    from ..config import find_ntt_root
    from ..io.serialize import intt_root_table
    logn = n.bit_length() - 1
    w = find_ntt_root(n, q)
    tbl = intt_root_table(n, logn, q, w)
    inv_n = pow(n, q - 2, q)
    last_inv_sn = int(tbl[n - 1]) * inv_n % q
    return ((inv_n, barrett_quotient(inv_n, q) & 0xFFFFFFFF),
            (last_inv_sn, barrett_quotient(last_inv_sn, q) & 0xFFFFFFFF))


def intt_lazy_with_tables(x, op, quot, q: int):
    """Lazy ("fast") INTT with MUMO tables in the reference's INTT file
    order (intt_lazy_inpl, intt.c:72-129 + the [0,q) correction at
    intt.c:490-496): values accumulate in [0, 2q) across rounds, the
    final round is merged with the inv_n / last_inv_sn multiplication,
    and one correction pass lands canonical [0, q).

    op/quot: u32 (n,) — e.g. the columns of a loaded
    ``intt_fast_roots_<n>_<q>.dat`` (io.serialize.read_ntt_roots
    fast=True), whose root order table[bitrev(i-1, logn)+1] differs from
    intt_tables' forward indexing; round h reads rows [n-2h+1, n-h+1).
    Value-identical to intt() (asserted in tests/test_stream_io.py).
    """
    n = x.shape[-1]
    logn = n.bit_length() - 1
    batch_shape = x.shape[:-1]
    v = x.astype(U32)
    two_q = 2 * q

    h, tt = n // 2, 1
    for _ in range(logn - 1):
        v = v.reshape(batch_shape + (h, 2, tt))
        u = v[..., 0, :]
        w_ = v[..., 1, :]
        s_op = op[n - 2 * h + 1: n - h + 1] \
            .reshape((1,) * len(batch_shape) + (h, 1))
        s_quot = quot[n - 2 * h + 1: n - h + 1] \
            .reshape((1,) * len(batch_shape) + (h, 1))
        val1 = (u + w_).astype(U32)
        val1 = jnp.where(val1 >= two_q, val1 - two_q, val1)
        val2 = (u + two_q - w_).astype(U32)
        t = mul_mod_shoup_lazy(val2, s_op, s_quot, q)
        v = jnp.stack([val1, t], axis=-2)
        h, tt = h // 2, tt * 2

    v = v.reshape(batch_shape + (n,))
    (inv_n, inv_n_q), (lsn, lsn_q) = intt_lazy_consts(n, q)
    u = v[..., : n // 2]
    w_ = v[..., n // 2:]
    val1 = (u + w_).astype(U32)
    val1 = jnp.where(val1 >= two_q, val1 - two_q, val1)
    val2 = (u + two_q - w_).astype(U32)
    lo = mul_mod_shoup_lazy(val1, jnp.asarray(inv_n, U32),
                            jnp.asarray(inv_n_q, U32), q)
    hi = mul_mod_shoup_lazy(val2, jnp.asarray(lsn, U32),
                            jnp.asarray(lsn_q, U32), q)
    v = jnp.concatenate([lo, hi], axis=-1)
    return jnp.where(v >= q, v - q, v).astype(U32)


@lru_cache(maxsize=64)
def _gen_powers(n: int, q: int) -> tuple:
    """The logn generator squarings w^(2^b) mod q (host scalars) plus the
    static bitrev gather — the ONLY precomputed state of the OTF mode."""
    logn = n.bit_length() - 1
    w = find_ntt_root(n, q)
    sq = tuple(pow(w, 1 << b, q) for b in range(logn))
    brv = np.array([bitrev(i, logn) for i in range(n)], dtype=np.int32)
    return sq, brv


def ntt_roots_ingraph(n: int, q: int):
    """Synthesize the bitrev-indexed root vector IN-GRAPH from the logn
    generator squarings — the OTF/compute capability axis of the
    reference (SE_NTT_TYPE 0/1: ntt.c:144-149 computes each group root
    by exponentiate_uint_mod_bitrev, ntt.c:40-52 computes the table once;
    here the whole table is built per call by log-depth doubling, the
    batched equivalent of the same square chain).

    Memory trade-off vs table mode: nothing (n,)-sized persists in HBM —
    only logn scalar constants enter the graph; the table is transient
    per call.  At n=16384/L=13 that releases ~3.4 MB of HBM-resident
    forward tables (SURVEY.md S5 memory/HBM option space)."""
    from .modarith import mul_mod
    sq, brv = _gen_powers(n, q)
    pows = jnp.ones((1,), U32)
    for wb in sq:  # pows_{b+1} = [pows_b, pows_b * w^(2^b)]
        pows = jnp.concatenate([pows, mul_mod(pows, jnp.uint32(wb), q)])
    return pows[jnp.asarray(brv)]


def ntt_otf(x, q: int):
    """Forward negacyclic NTT with on-the-fly roots (SE_NTT_TYPE 0
    analog): no precomputed Shoup tables — roots synthesized in-graph
    (ntt_roots_ingraph) and butterflies in the reference's NON-lazy form
    (plain Barrett mul_mod + canonical add/sub per stage,
    ntt.c:124-165), exactly the arithmetic the reference's OTF mode uses
    (no quotient table exists to be lazy with).

    Output is value-identical to ntt() — same canonical [0, q) scrambled
    NTT (asserted in tests/test_ops.py)."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    op = ntt_roots_ingraph(n, q)
    batch_shape = x.shape[:-1]
    v = x.astype(U32)

    from .modarith import add_mod, mul_mod, sub_mod
    h, tt = 1, n // 2
    for _ in range(logn):
        v = v.reshape(batch_shape + (h, 2, tt))
        u = v[..., 0, :]
        w_ = v[..., 1, :]
        s = op[h:2 * h].reshape((1,) * len(batch_shape) + (h, 1))
        t = mul_mod(w_, s, q)
        v = jnp.stack([add_mod(u, t, q), sub_mod(u, t, q)], axis=-2)
        h, tt = h * 2, tt // 2
    return v.reshape(batch_shape + (n,)).astype(U32)


def pointwise_mul_mod(a, b, q):
    """NTT-domain multiply = coefficient-wise mul mod q (ntt.h:66-85)."""
    from .modarith import mul_mod
    return mul_mod(a, b, q)


def ntt_tables_stacked(n: int, moduli) -> tuple[np.ndarray, np.ndarray]:
    """Forward tables stacked over the limb axis: u32 (L, n) each."""
    ops, quots = zip(*(ntt_tables(n, int(q)) for q in moduli))
    return np.stack(ops), np.stack(quots)


def ntt_with_tables(x, op, quot, q):
    """Forward NTT over the last axis with explicit (possibly traced) root
    tables and modulus — the data-driven core used by limb-scan / shard_map
    pipelines.  x: u32 (..., n); op/quot: u32 (n,) or broadcastable;
    q: int, scalar tracer, or Mod."""
    from .modarith import _q
    n = x.shape[-1]
    logn = n.bit_length() - 1
    batch_shape = x.shape[:-1]
    v = x.astype(U32)
    qv = jnp.asarray(_q(q)).astype(U32)
    two_q = (qv * 2).astype(U32)

    h, tt = 1, n // 2
    for _ in range(logn):
        v = v.reshape(batch_shape + (h, 2, tt))
        u = v[..., 0, :]
        w_ = v[..., 1, :]
        s_op = op[..., h:2 * h].reshape((1,) * len(batch_shape) + (h, 1))
        s_quot = quot[..., h:2 * h].reshape((1,) * len(batch_shape) + (h, 1))
        u = jnp.where(u >= two_q, u - two_q, u)
        t = mul_mod_shoup_lazy(w_, s_op, s_quot, qv)
        v = jnp.stack([u + t, u + two_q - t], axis=-2)
        h, tt = h * 2, tt // 2

    v = v.reshape(batch_shape + (n,))
    v = jnp.where(v >= two_q, v - two_q, v)
    v = jnp.where(v >= qv, v - qv, v)
    return v.astype(U32)
