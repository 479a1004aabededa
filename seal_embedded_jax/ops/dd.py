"""Double-double (two-float32) arithmetic.

For backends without native f64, where XLA emulates it at great cost.
The CKKS encode IFFT
(reference: device/lib/fft.c, ckks_common.c:105-215) needs ~2^-40 relative
accuracy at scale 2^25 so plain f32 (2^-23) is marginal, while double-double
f32 carries ~2^-45 — comfortably beyond the reference's own f64 rounding
needs for decode-correct encodings.

Error-free transforms use Dekker/Veltkamp splitting only (no FMA
dependency), so results are exact products/sums of IEEE f32 ops, as long
as the compiler keeps each f32 multiply and add separately rounded.

A dd number is a pair (hi, lo) of f32 arrays with value hi + lo and
|lo| <= ulp(hi)/2.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

F32 = jnp.float32
_SPLITTER = np.float32(4097.0)  # 2^12 + 1 (Veltkamp split for f32)


def two_sum(a, b):
    """Error-free a + b -> (s, err)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| -> (s, err)."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """Veltkamp split: a = hi + lo with hi, lo 12-bit-mantissa exact."""
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free a * b -> (p, err) via Dekker's algorithm."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def dd_add(xh, xl, yh, yl):
    """Full double-double addition (Knuth)."""
    s1, s2 = two_sum(xh, yh)
    t1, t2 = two_sum(xl, yl)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def dd_neg(xh, xl):
    return -xh, -xl


def dd_sub(xh, xl, yh, yl):
    return dd_add(xh, xl, -yh, -yl)


def dd_mul(xh, xl, yh, yl):
    """Double-double multiplication."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def dd_from_f64(x) -> tuple[np.ndarray, np.ndarray]:
    """Host-side constant conversion: f64 array -> (hi, lo) f32 pair."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def dd_round_away(xh, xl):
    """round(hi+lo) half-away-from-zero (C99 round, ckks_common.c:192),
    returned as int64.

    Exact when hi+lo is not within ~2^-45 of a tie; at scale 2^25 the
    probability of a differing tie-break vs f64 is ~2^-20 per coefficient
    and affects the encoding by at most 1 ulp of plaintext (far below the
    CKKS error floor sigma~3.2).
    """
    # r = nearest integer to hi.  For |hi| >= 2^24 every f32 is an integer
    # and +0.5 is absorbed, so r == hi exactly; below 2^24 floor(|hi|+0.5)
    # is exact.
    r = jnp.where(xh < 0, -jnp.floor(-xh + 0.5), jnp.floor(xh + 0.5))
    # Residual d = (hi - r) + lo; hi - r is exact (Sterbenz), |d| can reach
    # ulp(hi)/2 when hi >= 2^24, so round it the same way.
    d = (xh - r) + xl
    adj = jnp.where(d < 0, -jnp.floor(-d + 0.5), jnp.floor(d + 0.5))
    return r.astype(jnp.int64) + adj.astype(jnp.int64)
