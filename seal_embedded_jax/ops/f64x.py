"""Exact software IEEE-754 binary64 arithmetic on integer lanes ("f64x").

Where f64 is emulated or its multiply-adds are contracted, XLA's f64 is
not IEEE-bit-exact.  The reference encode (device/lib/ckks_common.c:105-215 + fft.c) is defined in
IEEE f64, and bit-exact ciphertexts require reproducing its *rounding
errors*, not just its math.  This module therefore implements binary64
add/sub/mul with round-to-nearest-even exactly, using only integer jnp
ops (u64 mantissa + i64 exponent + u32 sign planes) — every operation
vectorizes and the whole encode IFFT runs on device with zero host
round-trips.

Scope: finite values only (no inf/nan propagation — unreachable for the
encode pipeline's bounded inputs) but with full subnormal support on
inputs/outputs of each op, exact sign-of-zero semantics, and RNE ties.
Verified bit-for-bit against IEEE f64 (the CPU backend) on millions of
random add/mul cases and against the C-reference golden encode vectors
(tests/test_f64x.py).

Representation: value = (-1)^s * m * 2^(e - 52) with either m == 0
(zero; e = E_ZERO) or 2^52 <= m < 2^53 (normalized).  IEEE subnormals
are representable as normalized (m, e) pairs with e < E_MIN; rounding
re-quantizes results that fall below E_MIN exactly like hardware
(shiftRightJam into the subnormal grid).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
U64 = jnp.uint64
I32 = jnp.int32
I64 = jnp.int64

E_MIN = -1022      # minimum normal exponent
E_ZERO = -0x4000_0000  # exponent tag for zero (far below any real one)


class F64X(NamedTuple):
    """Unpacked binary64 planes: sign u32 (0/1), exponent i32, mantissa
    u64 (0, or in [2^52, 2^53)).  Exponents of representable finite f64
    fit comfortably in i32 (range ~[-1128, 1024] plus the E_ZERO tag);
    keeping the plane 32-bit halves the emulated-64-bit lane work for
    every exponent compare/add/select."""
    s: jnp.ndarray
    e: jnp.ndarray
    m: jnp.ndarray


def _u64(x):
    return x.astype(U64)


def _i32(x):
    return x.astype(I32)


# ---------------------------------------------------------------------------
# Conversions


def from_np_f64(x: np.ndarray) -> F64X:
    """Host-side exact unpack of IEEE f64 (for root tables / constants)."""
    b = np.asarray(x, dtype=np.float64).view(np.uint64)
    s = (b >> 63).astype(np.uint32)
    e11 = ((b >> 52) & 0x7FF).astype(np.int64)
    m52 = (b & ((1 << 52) - 1)).astype(np.uint64)
    assert not np.any(e11 == 0x7FF), "inf/nan not supported"
    m = np.where(e11 > 0, m52 | (1 << 52), m52)
    e = np.where(e11 > 0, e11 - 1023, np.int64(E_MIN))
    # Normalize subnormals (and zeros -> E_ZERO).
    out_m = m.copy()
    out_e = e.copy()
    sub = (e11 == 0) & (m52 != 0)
    if np.any(sub):
        mm = m[sub]
        ee = e[sub]
        sh = (52 - (np.frexp(mm.astype(np.float64))[1] - 1)).astype(np.uint64)
        out_m[sub] = mm << sh
        out_e[sub] = ee - sh.astype(np.int64)
    out_e[m == 0] = E_ZERO
    # Host numpy planes (not jnp): results may be cached across jit traces,
    # and device constants created inside a trace must not escape it.
    return F64X(s, out_e.astype(np.int32), out_m)


def to_np_f64(v: F64X) -> np.ndarray:
    """Host-side exact repack to IEEE f64 (test oracle)."""
    s = np.asarray(v.s).astype(np.uint64)
    e = np.asarray(v.e).astype(np.int64)
    m = np.asarray(v.m).astype(np.uint64)
    out = np.zeros(m.shape, dtype=np.uint64)
    nz = m != 0
    # Subnormal outputs (e < E_MIN) must already be exactly representable.
    sub = nz & (e < E_MIN)
    sh = np.where(sub, E_MIN - e, 0).astype(np.uint64)
    mask = (np.uint64(1) << sh) - np.uint64(1)
    assert not np.any(sub & ((m & mask) != 0)), "inexact subnormal repack"
    msub = m >> sh
    e11 = np.where(sub, 0, e + 1023).astype(np.uint64)
    frac = np.where(sub, msub, m & np.uint64((1 << 52) - 1))
    out[nz] = (e11[nz] << 52) | frac[nz]
    out |= s << 63
    return out.view(np.float64)


def from_f32(x) -> F64X:
    """Exact f32 -> f64x (every float32 is exactly representable)."""
    b = jax.lax.bitcast_convert_type(x.astype(jnp.float32), U32)
    s = (b >> 31).astype(U32)
    e8 = _i32((b >> 23) & jnp.uint32(0xFF))
    m23 = _u64(b & jnp.uint32(0x7FFFFF))
    normal = e8 > 0
    m = jnp.where(normal, (m23 | _u64(jnp.uint64(1 << 23))) << 29, m23)
    # Subnormal f32: value = m23 * 2^-149 = m23 * 2^(e - 52) with e = -97.
    e = jnp.where(normal, e8 - 127, jnp.int32(-97))
    # Normalize f32 subnormals / zeros.
    nz = m != 0
    sh = jnp.where(nz, 52 - (63 - _i32(jax.lax.clz(m.astype(I64)))), 0)
    sh = jnp.where(normal | ~nz, 0, sh)
    m = jnp.where(normal | ~nz, m, m << _u64(sh))
    e = jnp.where(nz, e - sh, jnp.int32(E_ZERO))
    return F64X(s, e, m)


def zeros(shape) -> F64X:
    return F64X(jnp.zeros(shape, U32),
                jnp.full(shape, E_ZERO, I32),
                jnp.zeros(shape, U64))


def broadcast_to(v: F64X, shape) -> F64X:
    return F64X(jnp.broadcast_to(v.s, shape),
                jnp.broadcast_to(v.e, shape),
                jnp.broadcast_to(v.m, shape))


# ---------------------------------------------------------------------------
# Core ops


def _shift_right_jam(m, d):
    """m >> d with all shifted-out bits OR-jammed into the LSB; d >= 0,
    saturating at 63 (m < 2^63 always here)."""
    d = jnp.minimum(d, 63).astype(U64)
    shifted = m >> d
    lost = (shifted << d) != m
    return shifted | lost.astype(U64)


def _round_pack(s, e, m31):
    """Round a 56-bit working mantissa (value = m31 * 2^(e - 55), i.e. 53
    result bits + guard/round/sticky in the low 3) to nearest-even,
    re-quantizing into the subnormal grid when e < E_MIN.  Returns F64X."""
    # Subnormal range: need result ulp = 2^(E_MIN - 52); shift right so the
    # working mantissa's bit 3 is that ulp.
    extra = jnp.maximum(_i32(E_MIN - e), 0)
    m31 = _shift_right_jam(m31, extra)
    e = e + extra

    lsb = (m31 >> 3) & jnp.uint64(1)
    guard = (m31 >> 2) & jnp.uint64(1)
    rs = m31 & jnp.uint64(3)
    up = (guard == 1) & ((rs != 0) | (lsb == 1))
    m = (m31 >> 3) + up.astype(U64)
    # Mantissa overflow after round-up: 2^53 -> 2^52, e+1.
    ovf = m == jnp.uint64(1 << 53)
    m = jnp.where(ovf, m >> 1, m)
    e = jnp.where(ovf, e + 1, e)
    # Subnormal results may be denormal (m < 2^52) at e == E_MIN after the
    # pre-shift; renormalize representation (value unchanged).
    nz = m != 0
    sh = jnp.where(nz, 52 - (63 - _i32(jax.lax.clz(m.astype(I64)))), 0)
    sh = jnp.maximum(sh, 0)
    m = m << _u64(sh)
    e = jnp.where(nz, e - sh, jnp.int32(E_ZERO))
    return F64X(s, e, m)


def _round_pack_ns(s, e, m31):
    """_round_pack for provably non-subnormal results: drops the
    subnormal-grid requantize shift and the denormal renormalize (a
    64-bit clz + shift per call).  Callers must guarantee e >= E_MIN for
    every nonzero result — see no_subnormals() for the encode-pipeline
    proof."""
    lsb = (m31 >> 3) & jnp.uint64(1)
    guard = (m31 >> 2) & jnp.uint64(1)
    rs = m31 & jnp.uint64(3)
    up = (guard == 1) & ((rs != 0) | (lsb == 1))
    m = (m31 >> 3) + up.astype(U64)
    ovf = m == jnp.uint64(1 << 53)
    m = jnp.where(ovf, m >> 1, m)
    e = jnp.where(ovf, e + 1, e)
    return F64X(s, e, m)


def safe_e_floor() -> int:
    """Exponent floor validating the no-subnormal fast path (E_MIN + 2).

    _round_pack_ns differs from _round_pack only in the subnormal
    requantize (triggered when the pre-round exponent is < E_MIN) and the
    denormal renormalize that requantizing can make necessary.  Rounding
    moves the exponent by at most 1, so any op OUTPUT with m == 0 or
    e >= E_MIN + 2 is guaranteed to have taken the requantize-free path —
    i.e. its _ns result is bit-identical to full IEEE.  Checking every
    op's output (inputs are exact-f32 promotions, normal twiddle
    constants, or previous outputs, so induction closes) therefore
    *proves* bit-exactness per batch element.  The encode pipeline folds
    this check into its `ok` flag via a running masked-min of exponents
    (see ops/encode.py); real inputs sit hundreds of octaves above the
    floor, so a False here is as unreachable as the encode-overflow
    flag — but the claim stays sound for adversarial inputs."""
    return E_MIN + 2


def _align(a: F64X, b: F64X):
    """Magnitude-order and exponent-align two operands (shared by add and
    add_sub).  Returns (a_big, eb_, MB, MS): big/small working mantissas
    with 6 spare low bits (guard/round/sticky + 1-bit renorm headroom),
    the small one shift-right-jammed into the big one's scale."""
    a_big = (a.e > b.e) | ((a.e == b.e) & (a.m >= b.m))
    eb_ = jnp.where(a_big, a.e, b.e)
    mb_ = jnp.where(a_big, a.m, b.m)
    es_ = jnp.where(a_big, b.e, a.e)
    ms_ = mb_ ^ a.m ^ b.m  # the other mantissa without a second where
    d = _i32(eb_ - es_)
    MB = mb_ << _u64(jnp.uint64(6))
    MS = _shift_right_jam(ms_ << _u64(jnp.uint64(6)), d)
    return a_big, eb_, MB, MS


def _add_finish(same, sb_, eb_, MB, MS, subnormals: bool,
                a=None, b=None, flip_b: bool = False) -> F64X:
    """Combine aligned mantissas for one sign pattern and round."""
    S = jnp.where(same, MB + MS, MB - MS)   # < 2^60 ; >= 0

    # Same sign: if carry past bit 58 (m*2^6 in [2^58, 2^59)), shift-jam 1.
    carry = same & (S >= jnp.uint64(1 << 59))
    S = jnp.where(carry, _shift_right_jam(S, jnp.int32(1)), S)
    e = jnp.where(carry, eb_ + 1, _i32(eb_))

    # Opposite sign: renormalize left.  d >= 2 needs at most 1 bit; d <= 1
    # is exact (sticky-free) so a full clz shift is safe.
    nz = S != 0
    lead = 63 - _i32(jax.lax.clz(S.astype(I64)))   # top set bit
    sh = jnp.where(~same & nz, 58 - lead, 0)
    sh = jnp.maximum(sh, 0)
    S = S << _u64(sh)
    e = e - sh

    rp = _round_pack if subnormals else _round_pack_ns
    out = rp(sb_, e, _shift_right_jam(S, jnp.int32(3)))

    # Exact cancellation of opposite signs -> +0 (RNE).  (Both-zero with
    # equal signs keeps sb_ via the same-sign path: -0 + -0 = -0.)
    cancel = ~same & ~nz
    s = jnp.where(cancel, 0, out.s)
    e = jnp.where(cancel, jnp.int32(E_ZERO), out.e)
    m = jnp.where(cancel, jnp.uint64(0), out.m)
    if a is not None:
        bs = (b.s ^ jnp.uint32(1)) if flip_b else b.s
        a_zero = a.m == 0
        b_zero = b.m == 0
        both0 = a_zero & b_zero
        s = jnp.where(both0, a.s & bs, jnp.where(a_zero, bs,
                      jnp.where(b_zero, a.s, s)))
        e = jnp.where(a_zero & ~both0, b.e,
                      jnp.where(b_zero & ~both0, a.e, e))
        m = jnp.where(a_zero & ~both0, b.m,
                      jnp.where(b_zero & ~both0, a.m, m))
    return F64X(s.astype(U32), e, m)


def add(a: F64X, b: F64X, subnormals: bool = True) -> F64X:
    """IEEE-754 binary64 addition, round-to-nearest-even.

    subnormals=False uses the no-subnormal fast rounding (see
    safe_e_floor()); results are identical whenever no intermediate
    dips below 2^-1022.

    Zero operands flow through the general path exactly (a zero is the
    lexicographic minimum, so it always aligns as the small operand with
    MS = 0 and the big operand re-rounds to itself; both-zero cases land
    on eb_ = E_ZERO with the IEEE sign rules falling out of the same/
    cancel logic) — verified exhaustively over sign/zero combinations in
    tests/test_f64x.py, so no special-case selects are spent on them."""
    a_big, eb_, MB, MS = _align(a, b)
    sb_ = jnp.where(a_big, a.s, b.s)
    same = a.s == b.s  # == (sign of small == sign of big), any ordering
    return _add_finish(same, sb_, eb_, MB, MS, subnormals, a, b)


def add_sub(a: F64X, b: F64X, subnormals: bool = True):
    """(a + b, a - b) with one shared alignment — bit-identical to
    (add(a, b), add(a, neg(b))) but ~25% cheaper, for butterflies that
    need both combinations of the same operands."""
    a_big, eb_, MB, MS = _align(a, b)
    sb1 = jnp.where(a_big, a.s, b.s)
    sb2 = jnp.where(a_big, a.s, b.s ^ jnp.uint32(1))
    same = a.s == b.s
    return (_add_finish(same, sb1, eb_, MB, MS, subnormals, a, b),
            _add_finish(~same, sb2, eb_, MB, MS, subnormals, a, b,
                        flip_b=True))


def guard_min_e(acc, *vals: F64X):
    """Fold op outputs into a running exponent min (zeros masked to 0),
    for the safe_e_floor() no-subnormal validity check."""
    for v in vals:
        acc = jnp.minimum(acc, jnp.where(v.m == 0, jnp.int32(0), v.e))
    return acc


def neg(a: F64X) -> F64X:
    return F64X(a.s ^ jnp.uint32(1), a.e, a.m)


def sub(a: F64X, b: F64X, subnormals: bool = True) -> F64X:
    return add(a, neg(b), subnormals)


def mul(a: F64X, b: F64X, subnormals: bool = True,
        b_nonzero: bool = False) -> F64X:
    """IEEE-754 binary64 multiplication, round-to-nearest-even.

    subnormals=False: see add().  b_nonzero=True skips the zero check on
    b (for constant twiddle operands, which are never zero)."""
    s = a.s ^ b.s
    zero = (a.m == 0) if b_nonzero else ((a.m == 0) | (b.m == 0))

    # 106-bit product of 53-bit mantissas via 32-bit halves (every partial
    # product is exact in u64: 21+32 and 32+32 bit operands).
    ah, al = a.m >> jnp.uint64(32), a.m & jnp.uint64(0xFFFFFFFF)
    bh, bl = b.m >> jnp.uint64(32), b.m & jnp.uint64(0xFFFFFFFF)
    t0 = al * bl
    t1 = ah * bl + al * bh               # < 2^54
    t2 = ah * bh                         # < 2^42
    mid = t1 + (t0 >> jnp.uint64(32))    # < 2^55, exact
    p_hi = t2 + (mid >> jnp.uint64(32))              # bits 64..105
    p_lo = (mid << jnp.uint64(32)) | (t0 & jnp.uint64(0xFFFFFFFF))

    # p in [2^104, 2^106).  Take the top 56 bits (53 + GRS) with jam.
    top = p_hi >= jnp.uint64(1 << 41)    # p >= 2^105
    shift = jnp.where(top, jnp.uint64(50), jnp.uint64(49))   # 106-56 / 105-56
    m31 = (p_hi << (jnp.uint64(64) - shift)) | (p_lo >> shift)
    jam = (p_lo << (jnp.uint64(64) - shift)) != 0
    m31 = m31 | jam.astype(U64)
    e = a.e + b.e + jnp.where(top, 1, 0)

    rp = _round_pack if subnormals else _round_pack_ns
    out = rp(s, _i32(e), m31)
    return F64X(out.s.astype(U32),
                jnp.where(zero, jnp.int32(E_ZERO), out.e),
                jnp.where(zero, jnp.uint64(0), out.m))


def round_away_i64(a: F64X):
    """C99 round(): nearest, ties away from zero -> signed i64.

    Returns (value i64, ok bool) where ok is False on |result| >= 2^63
    (the reference's encode overflow check, ckks_common.c:195-204)."""
    e = a.e
    m = a.m
    # e - 52 >= 0: integral, value = m << (e - 52).
    lsh = jnp.clip(e - 52, 0, 63)
    big = m << _u64(lsh)
    # e - 52 < 0: |r| = (m + 2^(shift-1)) >> shift, shift = 52 - e in [1, ..].
    rsh = jnp.clip(52 - e, 1, 63)
    half = jnp.uint64(1) << _u64(rsh - 1)
    small = (m + half) >> _u64(rsh)
    mag = jnp.where(e >= 52, big, small)
    mag = jnp.where(m == 0, jnp.uint64(0), mag)
    # Overflow: integral path must fit 63 bits pre- and post-shift.
    ok = ~((e >= 52) & ((e - 52 > 10) | (big >> _u64(lsh) != m)
                        | (big >= jnp.uint64(1 << 63))))
    ok = ok | (m == 0)
    v = jnp.where(a.s == 1, -mag.astype(I64), mag.astype(I64))
    return v, ok


# ---------------------------------------------------------------------------
# Structure helpers (for building IFFT butterflies over f64x planes)


def reshape(v: F64X, shape) -> F64X:
    return F64X(v.s.reshape(shape), v.e.reshape(shape), v.m.reshape(shape))


def index(v: F64X, idx) -> F64X:
    return F64X(v.s[idx], v.e[idx], v.m[idx])


def stack(vs, axis) -> F64X:
    return F64X(jnp.stack([v.s for v in vs], axis=axis),
                jnp.stack([v.e for v in vs], axis=axis),
                jnp.stack([v.m for v in vs], axis=axis))


def scatter_set(target: F64X, idx, val: F64X) -> F64X:
    return F64X(target.s.at[idx].set(val.s),
                target.e.at[idx].set(val.e),
                target.m.at[idx].set(val.m))
