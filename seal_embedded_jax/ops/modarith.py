"""Vectorized exact 32-bit modular arithmetic (jnp, u32 lanes).

The reference's scalar Barrett layer (device/lib/modulo.h, uintmodarith.h,
uint_arith.h) re-designed as lane-parallel uint32 ops: every primitive is an
elementwise op over arbitrarily-shaped uint32 arrays, exact on every
backend (multiply-high is built from 16-bit limbs, avoiding 64-bit ops in
the hot path).

All functions are jit-safe and shape-polymorphic; moduli arrive as Python
ints (static under jit) so Barrett constants fold into the compiled program.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import barrett_quotient, const_ratio

U32 = jnp.uint32
_MASK16 = 0xFFFF


class Mod(NamedTuple):
    """Modulus constants; scalars (static Python ints) or arrays (per-limb
    data, enabling lax.scan / shard_map over the RNS-limb axis)."""
    q: Any
    r0: Any   # low word of floor(2^64/q)
    r1: Any   # high word of floor(2^64/q)
    max_multiple: Any  # uniform-sampler rejection bound (sample.c:46)


def as_mod(q) -> "Mod":
    """int modulus -> static Mod (np.uint32 scalars, immune to int32
    weak-type overflow); Mod passes through."""
    if isinstance(q, Mod):
        return q
    r0, r1 = const_ratio(q)
    mm = 0xFFFFFFFF - (0xFFFFFFFF % q) - 1
    return Mod(np.uint32(q), np.uint32(r0), np.uint32(r1), np.uint32(mm))


def modpack(moduli) -> "Mod":
    """Stacked per-limb Mod arrays (u32 (L,)) for limb-scan/shard pipelines."""
    ms = [as_mod(int(q)) for q in moduli]
    return Mod(
        np.array([m.q for m in ms], np.uint32),
        np.array([m.r0 for m in ms], np.uint32),
        np.array([m.r1 for m in ms], np.uint32),
        np.array([m.max_multiple for m in ms], np.uint32),
    )


def mullo(a, b):
    """Low 32 bits of a*b (native wraparound u32 multiply)."""
    return (a * b).astype(U32)


def mulhi(a, b):
    """High 32 bits of the 64-bit product a*b, via 16-bit limbs.

    Equivalent of mul_uint32_high (uint_arith.h:67) without 64-bit emulation:
      a = a1<<16 | a0,  b = b1<<16 | b0
      hi = a1*b1 + carry chains of the two cross products.
    """
    a = a.astype(U32)
    b = jnp.asarray(b, U32)
    a0, a1 = a & _MASK16, a >> 16
    b0, b1 = b & _MASK16, b >> 16
    lo = a0 * b0
    t = a1 * b0 + (lo >> 16)          # < 2^32, no overflow
    t2 = a0 * b1 + (t & _MASK16)      # < 2^32, no overflow
    return (a1 * b1 + (t >> 16) + (t2 >> 16)).astype(U32)


def _q(q):
    """Extract the modulus value from an int/array/Mod operand."""
    return q.q if isinstance(q, Mod) else q


def shift_result(x, q):
    """Constant-time [0,2q) -> [0,q) (modulo.h:21-32)."""
    qv = _q(q)
    return jnp.where(x >= qv, x - qv, x).astype(U32)


def barrett32(x, q):
    """x (u32) mod q for q <= 31 bits (modulo.h:43-75)."""
    m = as_mod(q)
    tmp = mulhi(x, jnp.asarray(m.r1).astype(U32))
    tmp = (x - mullo(tmp, jnp.asarray(m.q).astype(U32))).astype(U32)
    return shift_result(tmp, m.q)


def barrett_wide(x_lo, x_hi, q):
    """64-bit (lo,hi u32 pair) mod q (modulo.h:84-116), exact u32 limbs."""
    m = as_mod(q)
    r0 = jnp.asarray(m.r0).astype(U32)
    r1 = jnp.asarray(m.r1).astype(U32)
    qv = jnp.asarray(m.q).astype(U32)

    right_hw = mulhi(x_lo, r0)
    mid_lo = mullo(x_lo, r1)
    mid_hi = mulhi(x_lo, r1)
    middle_lw = (right_hw + mid_lo).astype(U32)
    carry = (middle_lw < right_hw).astype(U32)
    middle_hw = (mid_hi + carry).astype(U32)

    mid2_lo = mullo(x_hi, r0)
    mid2_hi = mulhi(x_hi, r0)
    middle2_lw = (middle_lw + mid2_lo).astype(U32)
    carry2 = (middle2_lw < middle_lw).astype(U32)
    middle2_hw = (mid2_hi + carry2).astype(U32)

    tmp = (mullo(x_hi, r1) + middle_hw + middle2_hw).astype(U32)
    tmp = (x_lo - mullo(tmp, qv)).astype(U32)
    return shift_result(tmp, m.q)


def mul_mod(a, b, q):
    """(a*b) mod q for arbitrary u32 operands (uintmodarith.h:123)."""
    lo = mullo(a, b)
    hi = mulhi(a, b)
    return barrett_wide(lo, hi, q)


def add_mod(a, b, q):
    """(a+b) mod q; requires a+b < 2q (uintmodarith.h:26-42)."""
    return shift_result((a + b).astype(U32), q)


def neg_mod(a, q):
    """(-a) mod q; requires a <= q (uintmodarith.h:64-73)."""
    qv = jnp.asarray(_q(q)).astype(U32)
    return jnp.where(a == 0, jnp.asarray(0, U32), qv - a).astype(U32)


def sub_mod(a, b, q):
    """(a-b) mod q; requires a,b <= q."""
    return add_mod(a, neg_mod(b, q), q)


def mul_mod_shoup_lazy(x, y_op, y_quot, q):
    """Lazy Shoup/MUMO multiply: result in [0,2q) (uintmodarith.h:308-331).

    y_op < q with precomputed y_quot = floor(y_op * 2^32 / q).
    """
    op1 = mullo(x, y_op)
    op2 = mulhi(x, y_quot)
    return (op1 - mullo(op2, jnp.asarray(_q(q)).astype(U32))).astype(U32)


def mul_mod_shoup(x, y_op, y_quot, q):
    """Shoup multiply reduced to [0,q)."""
    return shift_result(mul_mod_shoup_lazy(x, y_op, y_quot, q), q)


def reduce_pte(lo, hi, neg, q):
    """int64 plaintext+error (|x| as (lo,hi) u32 pair, neg = sign mask) -> mod q
    (ckks_common.c:224-237: negative values map to q - (|x| mod q), keeping the
    reference's x<0, |x| % q == 0 -> q quirk)."""
    r = barrett_wide(lo, hi, q)
    qv = jnp.asarray(_q(q)).astype(U32)
    return jnp.where(neg, (qv - r).astype(U32), r)


def reduce_pte_i64(x, q):
    """Convenience variant from an int64 array."""
    ab = jnp.abs(x).astype(jnp.uint64)
    lo = (ab & jnp.uint64(0xFFFFFFFF)).astype(U32)
    hi = (ab >> jnp.uint64(32)).astype(U32)
    return reduce_pte(lo, hi, x < 0, q)
