"""Batched CKKS encode (jnp).

Re-design of the reference encode (device/lib/ckks_common.c:105-215 +
fft.c): slot placement via a precomputed gather (index map = generator-3
orbit merged with bitrev), vectorized IFFT butterfly rounds over separate
re/im f64 planes, fused scale-and-round to int64.

Three precisions (encode_any): 'f64' runs the butterflies in native f64 and
is bit-exact wherever each multiply and add rounds on its own, as in the C
reference; 'sf' is software IEEE-754 binary64 on integer lanes
(ops/f64x.py), bit-exact on any backend; 'dd' is double-double f32,
decode-exact only.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Parms, bitrev


@lru_cache(maxsize=32)
def index_map_np(n: int) -> np.ndarray:
    """Precomputed index map (ckks_common.c:32-68)."""
    from ..golden.encode import calc_index_map
    return calc_index_map(n, n.bit_length() - 1).astype(np.int32)


@lru_cache(maxsize=32)
def ifft_root_tables(n: int) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """Per-round conjugated roots, f64 (re, im), group-indexed.

    Round r (tt = 2^r, h = n >> (r+1)) uses s_j = conj(W^bitrev(h+j, logn))
    for groups j = 0..h-1 (fft.c:119-143, OTF order) — computed with libm
    cos/sin exactly like the reference.
    """
    logn = n.bit_length() - 1
    m = 2 * n
    out = []
    h = n // 2
    for _ in range(logn):
        re = np.zeros(h, dtype=np.float64)
        im = np.zeros(h, dtype=np.float64)
        for j in range(h):
            k = bitrev(h + j, logn) & (m - 1)
            ang = 2.0 * math.pi * float(k) / float(m)
            re[j] = math.cos(ang)
            im[j] = -math.sin(ang)  # conjugate
        out.append((re, im))
        h //= 2
    return tuple(out)


def ifft_root_tables_from_file(path: str, n: int):
    """Per-round IFFT root tables from an adapter-format roots file — the
    SE_IFFT_LOAD_FULL data path (user_defines.h:60-66, fileops.c:226-255).

    The file stores roots[i] = conj(W^(bitrev(i-1, logn) + 1)) as raw f64
    bit patterns (adapter generate.cpp:119-198); the device consumes them
    sequentially from index 1 in (round, group) order (fft.c:108-126
    ``roots[root_idx++]``), which is exactly the per-round layout
    ifft_root_tables() computes — so a loaded file reorders into the same
    structure, bit-for-bit (asserted in tests/test_stream_io.py).
    """
    from ..io.serialize import read_ifft_roots
    raw = read_ifft_roots(path, n)
    re_all, im_all = raw[0::2], raw[1::2]
    logn = n.bit_length() - 1
    out = []
    idx, h = 1, n // 2
    for _ in range(logn):
        out.append((re_all[idx:idx + h].copy(), im_all[idx:idx + h].copy()))
        idx, h = idx + h, h // 2
    return tuple(out)


@lru_cache(maxsize=32)
def fft_root_tables(n: int) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """Per-round forward (decode) roots (fft.c:183-213)."""
    logn = n.bit_length() - 1
    m = 2 * n
    out = []
    h = 1
    for _ in range(logn):
        re = np.zeros(h, dtype=np.float64)
        im = np.zeros(h, dtype=np.float64)
        for j in range(h):
            k = bitrev(h + j, logn) & (m - 1)
            ang = 2.0 * math.pi * float(k) / float(m)
            re[j] = math.cos(ang)
            im[j] = math.sin(ang)
        out.append((re, im))
        h *= 2
    return tuple(out)


def encode(values, parms: Parms, root_tables=None, imap=None):
    """values f32 (..., <= n/2) -> conj_vals_int int64 (..., n).

    Bit-exact to ckks_encode_base where f64 multiplies and adds each
    round (no fused multiply-add contraction).  root_tables: optional per-round IFFT tables (e.g. from
    ifft_root_tables_from_file — the SE_IFFT_LOAD_FULL path); imap:
    optional loaded index map (io.serialize.read_index_map — the
    SE_INDEX_MAP_LOAD path, fileops.c:208-225).  Both default to the
    computed equivalents (bit-identical; asserted in tests).
    """
    n, logn = parms.degree, parms.logn
    batch_shape = values.shape[:-1]
    vlen = values.shape[-1]
    if imap is None:
        imap = index_map_np(n)

    v = values.astype(jnp.float64)
    re = jnp.zeros(batch_shape + (n,), jnp.float64)
    re = re.at[..., imap[:vlen]].set(v)
    re = re.at[..., imap[n // 2: n // 2 + vlen]].set(v)
    im = jnp.zeros(batch_shape + (n,), jnp.float64)

    # IFFT rounds (fft.c:117-144): u' = u + w, w' = (u - w) * s.
    tt, h = 1, n // 2
    for (sre_np, sim_np) in (root_tables if root_tables is not None
                             else ifft_root_tables(n)):
        bshape = (1,) * len(batch_shape)
        sre = jnp.asarray(sre_np).reshape(bshape + (h, 1))
        sim = jnp.asarray(sim_np).reshape(bshape + (h, 1))
        re_v = re.reshape(batch_shape + (h, 2, tt))
        im_v = im.reshape(batch_shape + (h, 2, tt))
        ure, uim = re_v[..., 0, :], im_v[..., 0, :]
        wre, wim = re_v[..., 1, :], im_v[..., 1, :]
        dre, dim_ = ure - wre, uim - wim
        nre = jnp.stack([ure + wre, dre * sre - dim_ * sim], axis=-2)
        nim = jnp.stack([uim + wim, dre * sim + dim_ * sre], axis=-2)
        re = nre.reshape(batch_shape + (n,))
        im = nim.reshape(batch_shape + (n,))
        tt, h = tt * 2, h // 2

    n_inv = np.float64(parms.scale) / np.float64(n)
    x = re * n_inv
    # C99 round(): half away from zero (ckks_common.c:192).
    coeff = jnp.where(x < 0, -jnp.floor(-x + 0.5), jnp.floor(x + 0.5))
    ok = jnp.all(jnp.abs(coeff) <= np.float64(0x7FFFFFFFFFFFFFFF), axis=-1)
    return coeff.astype(jnp.int64), ok


@lru_cache(maxsize=32)
def ifft_root_tables_dd(n: int):
    """IFFT root tables as double-double f32 pairs (hi, lo) per round."""
    from .dd import dd_from_f64
    out = []
    for re, im in ifft_root_tables(n):
        out.append((dd_from_f64(re), dd_from_f64(im)))
    return tuple(out)


def encode_dd(values, parms: Parms):
    """Double-double f32 IFFT encode (see ops/dd.py).

    Same math as encode() but ~2^-45 relative accuracy instead of f64's
    2^-53 — decode-exact, for backends without native f64.
    Returns (conj_vals_int int64 (..., n), ok).
    """
    from . import dd

    n = parms.degree
    batch_shape = values.shape[:-1]
    vlen = values.shape[-1]
    imap = index_map_np(n)

    v = values.astype(jnp.float32)
    re_h = jnp.zeros(batch_shape + (n,), jnp.float32)
    re_h = re_h.at[..., imap[:vlen]].set(v)
    re_h = re_h.at[..., imap[n // 2: n // 2 + vlen]].set(v)
    re_l = jnp.zeros_like(re_h)
    im_h = jnp.zeros_like(re_h)
    im_l = jnp.zeros_like(re_h)

    tt, h = 1, n // 2
    for (sre_dd, sim_dd) in ifft_root_tables_dd(n):
        bshape = (1,) * len(batch_shape) + (h, 1)
        srh = jnp.asarray(sre_dd[0]).reshape(bshape)
        srl = jnp.asarray(sre_dd[1]).reshape(bshape)
        sih = jnp.asarray(sim_dd[0]).reshape(bshape)
        sil = jnp.asarray(sim_dd[1]).reshape(bshape)

        def pair(x):
            return x.reshape(batch_shape + (h, 2, tt))

        re_hv, re_lv = pair(re_h), pair(re_l)
        im_hv, im_lv = pair(im_h), pair(im_l)
        urh, url = re_hv[..., 0, :], re_lv[..., 0, :]
        uih, uil = im_hv[..., 0, :], im_lv[..., 0, :]
        wrh, wrl = re_hv[..., 1, :], re_lv[..., 1, :]
        wih, wil = im_hv[..., 1, :], im_lv[..., 1, :]

        # u' = u + w
        arh, arl = dd.dd_add(urh, url, wrh, wrl)
        aih, ail = dd.dd_add(uih, uil, wih, wil)
        # d = u - w;  w' = d * s (complex)
        drh, drl = dd.dd_sub(urh, url, wrh, wrl)
        dih, dil = dd.dd_sub(uih, uil, wih, wil)
        p1h, p1l = dd.dd_mul(drh, drl, srh, srl)
        p2h, p2l = dd.dd_mul(dih, dil, sih, sil)
        brh, brl = dd.dd_sub(p1h, p1l, p2h, p2l)
        p3h, p3l = dd.dd_mul(drh, drl, sih, sil)
        p4h, p4l = dd.dd_mul(dih, dil, srh, srl)
        bih, bil = dd.dd_add(p3h, p3l, p4h, p4l)

        def unpair(a, b):
            return jnp.stack([a, b], axis=-2).reshape(batch_shape + (n,))

        re_h, re_l = unpair(arh, brh), unpair(arl, brl)
        im_h, im_l = unpair(aih, bih), unpair(ail, bil)
        tt, h = tt * 2, h // 2

    sc_h, sc_l = (np.float32(x) for x in _scale_over_n_dd(parms))
    xh, xl = dd.dd_mul(re_h, re_l, sc_h, sc_l)
    coeff = dd.dd_round_away(xh, xl)
    ok = jnp.all(jnp.abs(xh) <= np.float32(9.2e18), axis=-1)
    return coeff, ok


def _scale_over_n_dd(parms: Parms):
    from .dd import dd_from_f64
    hi, lo = dd_from_f64(np.float64(parms.scale) / np.float64(parms.degree))
    return float(hi), float(lo)


@lru_cache(maxsize=32)
def _pease_tables(n: int):
    """Constant-geometry (Pease) IFFT schedule: per-round twiddle vectors
    and the final inverse permutation.

    The reference's DIT loop (fft.c:117-144) pairs indices differing in
    bit r at round r, with round-dependent (h, 2, tt) shapes.  Re-indexed
    so that every round is the SAME array program — butterfly adjacent
    pairs, then concat(sum-half, twiddled-half) — the data walks a fixed
    permutation chain and each original butterfly (same operands, same
    twiddle value, same f64 rounding) still executes exactly once, so
    results are bit-identical.  Uniform shapes make the whole IFFT one
    lax.scan body: the XLA graph shrinks ~log2(n)-fold vs the unrolled
    loop (compile time).

    Returns (S_re, S_im) f64 (logn, n/2) twiddles in scan order and
    inv (n,) int32: out[i] = scan_result[inv[i]].
    """
    logn = n.bit_length() - 1
    roots = ifft_root_tables(n)
    lam = np.arange(n)
    S_re = np.zeros((logn, n // 2))
    S_im = np.zeros((logn, n // 2))
    for r in range(logn):
        lu, lw = lam[0::2], lam[1::2]
        assert np.all((lu ^ lw) == (1 << r)) and np.all(((lu >> r) & 1) == 0)
        g = lu >> (r + 1)
        S_re[r] = roots[r][0][g]
        S_im[r] = roots[r][1][g]
        lam = np.concatenate([lu, lw])
    inv = np.argsort(lam).astype(np.int32)
    return S_re, S_im, inv


def encode_sf(values, parms: Parms):
    """Bit-exact encode anywhere: software IEEE-754 binary64 (ops/f64x.py).

    Identical results to encode() on an IEEE backend — same slot
    placement, same f64 butterfly rounding, same C99 round() — but every
    operation is integer jnp, so it is exact on any backend (verified
    bit-for-bit in tests/test_f64x.py).  Structured as one lax.scan over
    the constant-geometry round schedule (_pease_tables).
    Returns (conj_vals_int int64 (..., n), ok)."""
    from . import f64x as fx

    n = parms.degree
    batch_shape = values.shape[:-1]
    vlen = values.shape[-1]
    imap = index_map_np(n)
    S_re, S_im, inv = _pease_tables(n)
    s_fx = fx.F64X(*(jnp.asarray(p) for p in fx.from_np_f64(S_re)))
    c_fx = fx.F64X(*(jnp.asarray(p) for p in fx.from_np_f64(S_im)))

    v = values.astype(jnp.float32)
    re0 = jnp.zeros(batch_shape + (n,), jnp.float32)
    re0 = re0.at[..., imap[:vlen]].set(v)
    re0 = re0.at[..., imap[n // 2: n // 2 + vlen]].set(v)
    re = fx.from_f32(re0)            # exact: every f32 is an f64
    im = fx.zeros(batch_shape + (n,))

    pair_shape = batch_shape + (n // 2, 2)
    flat_shape = batch_shape + (n,)

    def split(x: fx.F64X):
        p = fx.reshape(x, pair_shape)
        return fx.index(p, np.s_[..., 0]), fx.index(p, np.s_[..., 1])

    # All butterfly arithmetic runs the no-subnormal fast rounding; the
    # running masked-min of every op's output exponent (guard_min_e)
    # proves per batch element that the fast path was exact (see
    # f64x.safe_e_floor()) and lands in the pipeline's ok flag.
    acc0 = jnp.zeros(batch_shape + (n // 2,), jnp.int32)

    def body(carry, s):
        re, im, acc = carry
        sre, sim = s
        ure, wre = split(re)
        uim, wim = split(im)
        # u' = u + w;  w' = (u - w) * s  (fft.c:117-144, complex); the
        # sum and difference share one alignment (fx.add_sub), and the
        # twiddle operand is never zero (b_nonzero).
        are, dre = fx.add_sub(ure, wre, False)
        aim, dim_ = fx.add_sub(uim, wim, False)
        p1 = fx.mul(dre, sre, False, b_nonzero=True)
        p2 = fx.mul(dim_, sim, False, b_nonzero=True)
        p3 = fx.mul(dre, sim, False, b_nonzero=True)
        p4 = fx.mul(dim_, sre, False, b_nonzero=True)
        bre = fx.sub(p1, p2, False)
        bim = fx.add(p3, p4, False)
        acc = fx.guard_min_e(acc, dre, dim_, p1, p2, p3, p4,
                             bre, bim, are, aim)
        re = fx.F64X(*(jnp.concatenate(p, axis=-1)
                       for p in zip(are, bre)))
        im = fx.F64X(*(jnp.concatenate(p, axis=-1)
                       for p in zip(aim, bim)))
        return (re, im, acc), None

    (re, im, acc), _ = jax.lax.scan(body, (re, im, acc0), (s_fx, c_fx))

    n_inv = fx.from_np_f64(np.float64(parms.scale) / np.float64(parms.degree))
    x = fx.mul(re, fx.F64X(*(jnp.asarray(p).reshape((1,) * len(flat_shape))
                             for p in n_inv)), False, b_nonzero=True)
    accx = fx.guard_min_e(jnp.zeros(flat_shape, jnp.int32), x)
    coeff, ok_c = fx.round_away_i64(x)
    floor = jnp.int32(fx.safe_e_floor())
    ok = (jnp.all(ok_c, axis=-1) & (acc.min(axis=-1) >= floor)
          & (accx.min(axis=-1) >= floor))
    return coeff[..., inv], ok


def encode_any(values, parms: Parms, mode: str = "dd"):
    """Dispatch between encode precisions: 'f64' (native f64, bit-exact
    where mul and add round separately), 'dd' (double-double f32,
    decode-exact), 'sf' (software IEEE f64, bit-exact everywhere)."""
    if mode == "f64":
        return encode(values, parms)
    if mode == "dd":
        return encode_dd(values, parms)
    if mode == "sf":
        return encode_sf(values, parms)
    raise ValueError(f"unknown encode mode {mode!r}")


def decode(pte_signed, parms: Parms):
    """Decode oracle (test-side): signed int64 coeffs -> n/2 slot reals."""
    n = parms.degree
    batch_shape = pte_signed.shape[:-1]
    re = pte_signed.astype(jnp.float64)
    im = jnp.zeros_like(re)
    h, tt = 1, n // 2
    for (sre_np, sim_np) in fft_root_tables(n):
        bshape = (1,) * len(batch_shape)
        sre = jnp.asarray(sre_np).reshape(bshape + (h, 1))
        sim = jnp.asarray(sim_np).reshape(bshape + (h, 1))
        re_v = re.reshape(batch_shape + (h, 2, tt))
        im_v = im.reshape(batch_shape + (h, 2, tt))
        ure, uim = re_v[..., 0, :], im_v[..., 0, :]
        wre = re_v[..., 1, :] * sre - im_v[..., 1, :] * sim
        wim = re_v[..., 1, :] * sim + im_v[..., 1, :] * sre
        re = jnp.stack([ure + wre, ure - wre], axis=-2).reshape(batch_shape + (n,))
        im = jnp.stack([uim + wim, uim - wim], axis=-2).reshape(batch_shape + (n,))
        h, tt = h * 2, tt // 2
    imap = index_map_np(n)
    return (re / np.float64(parms.scale))[..., imap[: n // 2]]


@lru_cache(maxsize=16)
def make_decoder(parms: Parms):
    """Cached jit of decode (eager execution pays per-op dispatch)."""
    return jax.jit(partial(decode, parms=parms))
