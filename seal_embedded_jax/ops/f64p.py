"""Planar u32-pair IEEE-754 binary64 arithmetic ("f64p") — the
Pallas-kernel-compatible form of ops/f64x.py.

For kernel languages without 64-bit types it keeps the mantissa as TWO
u32 planes (mhi < 2^21, mlo) alongside the i32 exponent and u32 sign
planes.  Every operation here is 32-bit jnp only (clz, variable shifts
and u32 multiplies) and runs on any backend, which
is how the module is tested: bit-for-bit against ops/f64x.py (itself
anchored to IEEE f64) over fuzzed operands and the golden encode vectors
(tests/test_f64p.py).

Scope matches the encode butterfly's needs: the no-subnormal fast
rounding only (f64x.safe_e_floor() guard contract — callers accumulate
guard_min_e and surface it in the pipeline ok flag), finite values, full
zero semantics.  Representation: value = (-1)^s * (mhi*2^32 + mlo) *
2^(e-52), normalized (mhi in [2^20, 2^21)) or zero (mhi=mlo=0,
e=E_ZERO).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .modarith import mulhi, mullo

U32 = jnp.uint32
I32 = jnp.int32

E_MIN = -1022
E_ZERO = -0x4000_0000


class F64P(NamedTuple):
    s: jnp.ndarray     # u32 0/1
    e: jnp.ndarray     # i32 (E_ZERO when zero)
    mhi: jnp.ndarray   # u32 < 2^21
    mlo: jnp.ndarray   # u32


def _u32(x):
    return x.astype(U32)


def _i32(x):
    return x.astype(I32)


# ----------------------------------------------------------------- u64 pairs


def _shl64(hi, lo, d):
    """(hi,lo) << d for d u32/i32 in [0, 63]; overflow bits lost."""
    d = _u32(d)
    big = d >= jnp.uint32(32)
    ds = jnp.where(big, d - jnp.uint32(32), d)
    lo_part = jnp.where(ds == 0, _u32(jnp.zeros_like(lo)),
                        lo >> ((jnp.uint32(32) - ds) & jnp.uint32(31)))
    nhi = jnp.where(big, _u32(lo << ds), _u32(hi << ds) | lo_part)
    nlo = jnp.where(big, _u32(jnp.zeros_like(lo)), _u32(lo << ds))
    return _u32(nhi), _u32(nlo)


def _shr64(hi, lo, d):
    """(hi,lo) >> d for d in [0, 63]."""
    d = _u32(d)
    big = d >= jnp.uint32(32)
    ds = jnp.where(big, d - jnp.uint32(32), d)
    hi_part = jnp.where(ds == 0, _u32(jnp.zeros_like(hi)),
                        hi << ((jnp.uint32(32) - ds) & jnp.uint32(31)))
    nlo = jnp.where(big, hi >> ds, (lo >> ds) | hi_part)
    nhi = jnp.where(big, _u32(jnp.zeros_like(hi)), hi >> ds)
    return _u32(nhi), _u32(nlo)


def _shr64_jam(hi, lo, d):
    """(hi,lo) >> min(d,63) with shifted-out bits OR-jammed into the LSB
    (f64x._shift_right_jam; values < 2^60 so saturation at 63 is total).
    d >= 0 (i32 or u32)."""
    d = jnp.minimum(_i32(d), jnp.int32(63))
    nhi, nlo = _shr64(hi, lo, d)
    big = _u32(d) >= jnp.uint32(32)
    ds = jnp.where(big, _u32(d) - jnp.uint32(32), _u32(d))
    mask = _u32((jnp.uint32(1) << ds) - jnp.uint32(1))
    # select on u32, not bool: Mosaic has no i1-vector select
    lost = jnp.where(big,
                     _u32((lo != jnp.uint32(0)) | ((hi & mask) != jnp.uint32(0))),
                     _u32((lo & mask) != jnp.uint32(0)))
    return nhi, nlo | lost


def _add64(ahi, alo, bhi, blo):
    lo = _u32(alo + blo)
    carry = (lo < alo).astype(U32)
    return _u32(ahi + bhi + carry), lo


def _sub64(ahi, alo, bhi, blo):
    lo = _u32(alo - blo)
    borrow = (alo < blo).astype(U32)
    return _u32(ahi - bhi - borrow), lo


def _ge64(ahi, alo, bhi, blo):
    return (ahi > bhi) | ((ahi == bhi) & (alo >= blo))


def _clz64(hi, lo):
    """Leading zeros of the 64-bit pair (0 input -> 64)."""
    czh = jax.lax.clz(_i32(hi)) & jnp.int32(63)
    czl = jax.lax.clz(_i32(lo)) & jnp.int32(63)
    czh = jnp.where(hi == jnp.uint32(0), jnp.int32(32), czh)
    czl = jnp.where(lo == jnp.uint32(0), jnp.int32(32), czl)
    return jnp.where(hi != jnp.uint32(0), czh, jnp.int32(32) + czl)


# ----------------------------------------------------------------- rounding


def _round_pack_ns(s, e, m31hi, m31lo):
    """f64x._round_pack_ns on pairs: round a 56-bit working mantissa
    (top bit 55; value m31 * 2^(e-55)) to nearest-even.  No subnormal
    requantize — caller guards via f64x.safe_e_floor()."""
    lsb = (m31lo >> jnp.uint32(3)) & jnp.uint32(1)
    guard = (m31lo >> jnp.uint32(2)) & jnp.uint32(1)
    rs = m31lo & jnp.uint32(3)
    up = ((guard == jnp.uint32(1)) & ((rs != jnp.uint32(0)) | (lsb == jnp.uint32(1)))).astype(U32)
    mhi = m31hi >> jnp.uint32(3)
    mlo = _u32((m31lo >> jnp.uint32(3)) | (m31hi << jnp.uint32(29)))
    mhi, mlo = _add64(mhi, mlo, jnp.zeros_like(mhi), up)
    ovf = (mhi == jnp.uint32(1 << 21)) & (mlo == jnp.uint32(0))
    mhi = jnp.where(ovf, jnp.uint32(1 << 20), mhi)
    e = jnp.where(ovf, e + jnp.int32(1), e)
    return F64P(_u32(s), _i32(e), _u32(mhi), mlo)


# ----------------------------------------------------------------- add / sub


def _align(a: F64P, b: F64P):
    """Magnitude-order + exponent-align (f64x._align on pairs)."""
    a_big = (a.e > b.e) | ((a.e == b.e)
                           & _ge64(a.mhi, a.mlo, b.mhi, b.mlo))
    eb = jnp.where(a_big, a.e, b.e)
    mbhi = jnp.where(a_big, a.mhi, b.mhi)
    mblo = jnp.where(a_big, a.mlo, b.mlo)
    es = jnp.where(a_big, b.e, a.e)
    mshi = mbhi ^ a.mhi ^ b.mhi
    mslo = mblo ^ a.mlo ^ b.mlo
    d = _i32(eb - es)
    MBhi = _u32((mbhi << jnp.uint32(6)) | (mblo >> jnp.uint32(26)))
    MBlo = _u32(mblo << jnp.uint32(6))
    thi = _u32((mshi << jnp.uint32(6)) | (mslo >> jnp.uint32(26)))
    tlo = _u32(mslo << jnp.uint32(6))
    MShi, MSlo = _shr64_jam(thi, tlo, d)
    return a_big, eb, MBhi, MBlo, MShi, MSlo


def _add_finish(same, sb, eb, MBhi, MBlo, MShi, MSlo) -> F64P:
    Sahi, Salo = _add64(MBhi, MBlo, MShi, MSlo)
    Sshi, Sslo = _sub64(MBhi, MBlo, MShi, MSlo)
    Shi = jnp.where(same, Sahi, Sshi)
    Slo = jnp.where(same, Salo, Sslo)

    # Same sign: carry past bit 58 -> shift-jam 1.
    carry = same & (Shi >= jnp.uint32(1 << 27))
    Shi_c = Shi >> jnp.uint32(1)
    Slo_c = _u32((Slo >> jnp.uint32(1)) | (Shi << jnp.uint32(31)) | (Slo & jnp.uint32(1)))
    Shi = jnp.where(carry, Shi_c, Shi)
    Slo = jnp.where(carry, Slo_c, Slo)
    e = jnp.where(carry, eb + jnp.int32(1), _i32(eb))

    # Opposite sign: renormalize left to bit 58.
    nz = (Shi | Slo) != jnp.uint32(0)
    lead = jnp.int32(63) - _clz64(Shi, Slo)
    sh = jnp.where((~same) & nz, jnp.int32(58) - lead, jnp.int32(0))
    sh = jnp.maximum(sh, jnp.int32(0))
    Shi, Slo = _shl64(Shi, Slo, sh)
    e = e - sh

    # m31 = S >> 3 with jam.
    m31hi = Shi >> jnp.uint32(3)
    m31lo = _u32((Slo >> jnp.uint32(3)) | (Shi << jnp.uint32(29)) | _u32((Slo & jnp.uint32(7)) != jnp.uint32(0)))
    out = _round_pack_ns(sb, e, m31hi, m31lo)

    cancel = (~same) & (~nz)
    return F64P(jnp.where(cancel, jnp.uint32(0), out.s),
                jnp.where(cancel, jnp.int32(E_ZERO), out.e),
                jnp.where(cancel, jnp.uint32(0), out.mhi),
                jnp.where(cancel, jnp.uint32(0), out.mlo))


def add(a: F64P, b: F64P) -> F64P:
    """a + b (RNE, no-subnormal rounding).  Zero operands flow through the
    general path exactly (see f64x.add docstring for the argument)."""
    a_big, eb, MBhi, MBlo, MShi, MSlo = _align(a, b)
    sb = jnp.where(a_big, a.s, b.s)
    same = a.s == b.s
    return _add_finish(same, sb, eb, MBhi, MBlo, MShi, MSlo)


def sub(a: F64P, b: F64P) -> F64P:
    return add(a, F64P(b.s ^ jnp.uint32(1), b.e, b.mhi, b.mlo))


def add_sub(a: F64P, b: F64P):
    """(a+b, a-b) with one shared alignment (f64x.add_sub on pairs)."""
    a_big, eb, MBhi, MBlo, MShi, MSlo = _align(a, b)
    sb1 = jnp.where(a_big, a.s, b.s)
    sb2 = jnp.where(a_big, a.s, b.s ^ jnp.uint32(1))
    same = a.s == b.s
    return (_add_finish(same, sb1, eb, MBhi, MBlo, MShi, MSlo),
            _add_finish(~same, sb2, eb, MBhi, MBlo, MShi, MSlo))


# ----------------------------------------------------------------- multiply


def mul(a: F64P, b: F64P, b_nonzero: bool = False) -> F64P:
    """a * b (RNE, no-subnormal rounding); b_nonzero skips b's zero check
    (twiddle operands)."""
    s = a.s ^ b.s
    zero = ((a.mhi | a.mlo) == jnp.uint32(0))
    if not b_nonzero:
        zero = zero | ((b.mhi | b.mlo) == jnp.uint32(0))

    # 106-bit product of the 53-bit mantissas (f64x.mul on pairs).
    t0hi, t0lo = mulhi(a.mlo, b.mlo), mullo(a.mlo, b.mlo)
    x1hi, x1lo = mulhi(a.mhi, b.mlo), mullo(a.mhi, b.mlo)
    x2hi, x2lo = mulhi(a.mlo, b.mhi), mullo(a.mlo, b.mhi)
    t1hi, t1lo = _add64(x1hi, x1lo, x2hi, x2lo)          # < 2^54
    t2hi, t2lo = mulhi(a.mhi, b.mhi), mullo(a.mhi, b.mhi)  # < 2^42
    zero32 = jnp.zeros_like(t0hi)
    midhi, midlo = _add64(t1hi, t1lo, zero32, t0hi)      # < 2^55
    phihi, philo = _add64(t2hi, t2lo, zero32, midhi)     # p>>64, < 2^42
    # p_lo = (midlo, t0lo)

    top = phihi >= jnp.uint32(1 << 9)                              # p >= 2^105
    shift = jnp.where(top, jnp.uint32(50), jnp.uint32(49))
    hhi, hlo = _shl64(phihi, philo, jnp.uint32(64) - shift)          # 14 / 15
    lhi, llo = _shr64(midlo, t0lo, shift)
    m31hi = hhi | lhi
    m31lo = hlo | llo
    # jam: low `shift` (>=32) bits of p_lo.
    mask = _u32((jnp.uint32(1) << (shift - jnp.uint32(32))) - jnp.uint32(1))
    jam = (t0lo != jnp.uint32(0)) | ((midlo & mask) != jnp.uint32(0))
    m31lo = m31lo | _u32(jam)

    e = a.e + b.e + _i32(top)
    out = _round_pack_ns(s, e, m31hi, m31lo)
    return F64P(out.s,
                jnp.where(zero, jnp.int32(E_ZERO), out.e),
                jnp.where(zero, jnp.uint32(0), out.mhi),
                jnp.where(zero, jnp.uint32(0), out.mlo))


# ----------------------------------------------------------------- round


def round_away_i64(a: F64P):
    """C99 round() -> signed i64 held as (lo, hi) u32 planes
    (f64x.round_away_i64 on pairs; ckks_common.c:192-206 semantics).

    Returns (lo u32, hi u32, ok bool) where ok is False on
    |result| >= 2^63 (the reference's encode overflow check)."""
    e = a.e
    # e - 52 >= 0: integral, value = m << (e - 52).
    lsh = jnp.clip(e - jnp.int32(52), jnp.int32(0), jnp.int32(63))
    bhi, blo = _shl64(a.mhi, a.mlo, lsh)
    # e - 52 < 0: |r| = (m + 2^(shift-1)) >> shift, shift = 52 - e in [1, 63].
    rsh = jnp.clip(jnp.int32(52) - e, jnp.int32(1), jnp.int32(63))
    hhi, hlo = _shl64(jnp.zeros_like(a.mhi), jnp.ones_like(a.mlo),
                      rsh - jnp.int32(1))
    thi, tlo = _add64(a.mhi, a.mlo, hhi, hlo)
    shi, slo = _shr64(thi, tlo, rsh)
    integral = e >= jnp.int32(52)
    mhi = jnp.where(integral, bhi, shi)
    mlo = jnp.where(integral, blo, slo)
    zero = (a.mhi | a.mlo) == jnp.uint32(0)
    mhi = jnp.where(zero, jnp.uint32(0), mhi)
    mlo = jnp.where(zero, jnp.uint32(0), mlo)
    # Overflow: integral path must fit 63 bits pre- and post-shift.
    rhi, rlo = _shr64(bhi, blo, lsh)
    bad = integral & ((e - jnp.int32(52) > jnp.int32(10))
                      | (rhi != a.mhi) | (rlo != a.mlo)
                      | (bhi >= jnp.uint32(1 << 31)))
    ok = (~bad) | zero
    # Signed: negate magnitude where s == 1 (two's complement on the pair).
    nlo = _u32(jnp.uint32(0) - mlo)
    nhi = _u32(~mhi + _u32(mlo == jnp.uint32(0)))
    neg = a.s == jnp.uint32(1)
    return (jnp.where(neg, nlo, mlo), jnp.where(neg, nhi, mhi), ok)


# ----------------------------------------------------------------- convert


def from_f32(x) -> F64P:
    """Exact f32 -> f64p (f64x.from_f32 on pairs)."""
    b = jax.lax.bitcast_convert_type(x.astype(jnp.float32), U32)
    s = b >> jnp.uint32(31)
    e8 = _i32((b >> jnp.uint32(23)) & jnp.uint32(0xFF))
    m23 = _u32(b & jnp.uint32(0x7FFFFF))
    normal = e8 > jnp.int32(0)
    mfull = m23 | jnp.uint32(1 << 23)
    # normal: m64 = mfull << 29 -> (mfull >> 3, mfull << 29)
    mhi_n = mfull >> jnp.uint32(3)
    mlo_n = _u32(mfull << jnp.uint32(29))
    e_n = e8 - jnp.int32(127)
    # f32 subnormal: value = m23 * 2^-149; normalize to bit 52.
    nzs = m23 != jnp.uint32(0)
    lead = jnp.int32(31) - (jax.lax.clz(_i32(m23)) & jnp.int32(63))
    sh = jnp.int32(52) - lead
    shi, slo = _shl64(jnp.zeros_like(m23), m23, jnp.where(nzs, sh, jnp.int32(0)))
    e_s = jnp.int32(-97) - jnp.where(nzs, sh, jnp.int32(0))

    zero = ~normal & ~nzs
    mhi = jnp.where(normal, mhi_n, jnp.where(nzs, shi, jnp.uint32(0)))
    mlo = jnp.where(normal, mlo_n, jnp.where(nzs, slo, jnp.uint32(0)))
    e = jnp.where(normal, e_n, jnp.where(nzs, e_s, jnp.int32(E_ZERO)))
    return F64P(_u32(s), _i32(e), _u32(mhi), _u32(mlo))


def guard_min_e(acc, *vals: F64P):
    """f64x.guard_min_e on pairs (no-subnormal validity accumulator)."""
    for v in vals:
        z = (v.mhi | v.mlo) == jnp.uint32(0)
        acc = jnp.minimum(acc, jnp.where(z, jnp.int32(0), v.e))
    return acc


# ------------------------------------------------------- host-side helpers


def split_np(v) -> F64P:
    """f64x planes (numpy; u64 m) -> F64P numpy planes."""
    m = np.asarray(v.m, dtype=np.uint64)
    return F64P(np.asarray(v.s, np.uint32), np.asarray(v.e, np.int32),
                (m >> np.uint64(32)).astype(np.uint32),
                (m & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def join_jnp(p: F64P):
    """F64P -> f64x.F64X (u64 m) for the jnp tail of split pipelines."""
    from . import f64x as fx
    m = (p.mhi.astype(jnp.uint64) << jnp.uint64(32)) | p.mlo.astype(jnp.uint64)
    return fx.F64X(p.s, p.e, m)
