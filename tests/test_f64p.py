"""f64p (planar u32-pair f64) vs f64x (u64 software IEEE f64): every op
bit-identical, including zero/sign corners — f64x itself is anchored to
IEEE on the CPU backend, so equality here transitively anchors the Pallas
kernel arithmetic to the C reference's f64 semantics."""

import numpy as np
import jax.numpy as jnp

from seal_embedded_jax.ops import f64p as fp
from seal_embedded_jax.ops import f64x as fx


def _to_p(v_np):
    x = fx.from_np_f64(v_np)
    return fp.F64P(*(jnp.asarray(q) for q in fp.split_np(x))), x


def _eq(p: fp.F64P, x: fx.F64X):
    got = fx.to_np_f64(fx.F64X(np.asarray(p.s), np.asarray(p.e),
                               (np.asarray(p.mhi).astype(np.uint64) << 32)
                               | np.asarray(p.mlo).astype(np.uint64)))
    want = fx.to_np_f64(x)
    return np.array_equal(got.view(np.uint64), want.view(np.uint64))


def _rand_ops(rng, shape, scale):
    a_np = rng.uniform(-scale, scale, shape)
    b_np = rng.uniform(-scale, scale, shape)
    # sprinkle exact zeros, negated zeros, equal values (cancellation)
    a_np.flat[::17] = 0.0
    b_np.flat[::23] = -0.0
    b_np.flat[::13] = a_np.flat[::13]          # a - b cancels exactly
    b_np.flat[::11] = -a_np.flat[::11]         # a + b cancels exactly
    return a_np, b_np


def test_add_sub_mul_bit_exact_vs_f64x():
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e3, 1e-3, 1e30, 1e-30):
        a_np, b_np = _rand_ops(rng, (64, 128), scale)
        ap, ax = _to_p(a_np)
        bp, bx = _to_p(b_np)
        assert _eq(fp.add(ap, bp), fx.add(ax, bx, False))
        assert _eq(fp.sub(ap, bp), fx.sub(ax, bx, False))
        assert _eq(fp.mul(ap, bp), fx.mul(ax, bx, False))
        s_p, d_p = fp.add_sub(ap, bp)
        s_x, d_x = fx.add_sub(ax, bx, False)
        assert _eq(s_p, s_x) and _eq(d_p, d_x)


def test_mul_b_nonzero_and_twiddle_range():
    rng = np.random.default_rng(1)
    a_np = rng.uniform(-2.0, 2.0, (32, 128))
    ang = rng.uniform(0, 2 * np.pi, (32, 128))
    b_np = np.cos(ang)  # twiddle-like, includes near-zero but nonzero
    ap, ax = _to_p(a_np)
    bp, bx = _to_p(b_np)
    assert _eq(fp.mul(ap, bp, b_nonzero=True),
               fx.mul(ax, bx, False, b_nonzero=True))


def test_from_f32_bit_exact():
    rng = np.random.default_rng(2)
    vals = rng.uniform(-1e3, 1e3, 4096).astype(np.float32)
    vals[::31] = 0.0
    vals[::37] = -0.0
    vals[1::41] = np.float32(1e-44)    # f32 subnormal
    vals[2::43] = -np.float32(1e-41)
    got = fp.from_f32(jnp.asarray(vals))
    want = fx.from_f32(jnp.asarray(vals))
    assert np.array_equal(np.asarray(got.s), np.asarray(want.s))
    assert np.array_equal(np.asarray(got.e), np.asarray(want.e))
    m = (np.asarray(got.mhi).astype(np.uint64) << 32) \
        | np.asarray(got.mlo).astype(np.uint64)
    assert np.array_equal(m, np.asarray(want.m))


def test_guard_min_e_matches():
    rng = np.random.default_rng(3)
    a_np = rng.uniform(-1, 1, (8, 128))
    a_np.flat[::7] = 0.0
    ap, ax = _to_p(a_np)
    accp = fp.guard_min_e(jnp.zeros((8, 128), jnp.int32), ap)
    accx = fx.guard_min_e(jnp.zeros((8, 128), jnp.int32), ax)
    assert np.array_equal(np.asarray(accp), np.asarray(accx))
