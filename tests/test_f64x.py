"""Software IEEE-754 binary64 (ops/f64x.py) vs the CPU backend's real IEEE
f64 — the correctness foundation of the backend-independent bit-exact
encode path."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax.ops import f64x as fx


def _rand_f64(rng, n, emin=-60, emax=60):
    x = rng.uniform(-1, 1, n) * np.exp2(rng.integers(emin, emax, n)
                                        .astype(np.float64))
    x[rng.random(n) < 0.01] = 0.0
    return x


def test_unpack_repack_roundtrip():
    rng = np.random.default_rng(0)
    x = _rand_f64(rng, 10000, -300, 300)
    x[:4] = [0.0, -0.0, 5e-324, -5e-324]  # zeros + extreme subnormals
    back = fx.to_np_f64(fx.from_np_f64(x))
    assert np.array_equal(back.view(np.uint64), x.view(np.uint64))


def test_from_f32_exact():
    rng = np.random.default_rng(1)
    v = rng.uniform(-4, 4, 10000).astype(np.float32)
    v[:3] = [0.0, np.float32(-0.0), np.float32(1e-42)]  # f32 subnormal
    got = fx.to_np_f64(fx.from_f32(jnp.asarray(v)))
    assert np.array_equal(got, v.astype(np.float64))
    # -0.0 sign preserved
    assert np.signbit(got[1])


def test_add_bit_exact_vs_ieee():
    rng = np.random.default_rng(2)
    N = 50000
    a, b = _rand_f64(rng, N), _rand_f64(rng, N)
    # Stress near-cancellation and exact cancellation.
    idx = rng.integers(0, N, N // 10)
    b[idx] = -a[idx] * (1 + np.exp2(rng.integers(-53, -1, N // 10)
                                    .astype(np.float64)))
    b[rng.integers(0, N, N // 20)] = 0.0
    idx2 = rng.integers(0, N, N // 20)
    b[idx2] = -a[idx2]
    got = fx.to_np_f64(jax.jit(fx.add)(fx.from_np_f64(a), fx.from_np_f64(b)))
    want = a + b
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def test_mul_bit_exact_vs_ieee():
    rng = np.random.default_rng(3)
    N = 50000
    a, b = _rand_f64(rng, N), _rand_f64(rng, N)
    got = fx.to_np_f64(jax.jit(fx.mul)(fx.from_np_f64(a), fx.from_np_f64(b)))
    want = a * b
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def test_mul_subnormal_results():
    """Products underflowing into the subnormal range round like hardware."""
    rng = np.random.default_rng(4)
    N = 20000
    a = _rand_f64(rng, N, -520, -500)
    b = _rand_f64(rng, N, -540, -500)
    got = fx.to_np_f64(jax.jit(fx.mul)(fx.from_np_f64(a), fx.from_np_f64(b)))
    want = a * b
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def test_round_away_i64():
    rng = np.random.default_rng(5)
    N = 50000
    c = rng.uniform(-1, 1, N) * np.exp2(rng.integers(-5, 62, N)
                                        .astype(np.float64))
    c[:1000] = np.arange(1000) + 0.5                      # ties away
    c[1000:2000] = -(np.arange(1000) + 0.5)
    c[2000:3000] = np.arange(1000) * np.exp2(40.0) + 0.5  # big + tie
    c[rng.random(N) < 0.01] = 0.0
    r, ok = jax.jit(fx.round_away_i64)(fx.from_np_f64(c))
    assert bool(np.asarray(ok).all())
    want = np.where(c >= 0, np.floor(np.abs(c) + 0.5),
                    -np.floor(np.abs(c) + 0.5)).astype(np.int64)
    assert np.array_equal(np.asarray(r), want)
    # Overflow flagged, not wrapped (ckks_common.c:195-204 semantics).
    r2, ok2 = fx.round_away_i64(fx.from_np_f64(
        np.array([np.exp2(63.0), -np.exp2(63.0), np.exp2(70.0)])))
    assert not np.asarray(ok2).any()
    r3, ok3 = fx.round_away_i64(fx.from_np_f64(
        np.array([np.nextafter(np.exp2(63.0), 0), 0.0])))
    assert np.asarray(ok3).all()


@pytest.mark.parametrize("n,L", [(1024, 1), (4096, 3)])
def test_encode_sf_bit_exact_vs_f64(n, L):
    """encode_sf == encode bit-for-bit on the IEEE (CPU) backend — which,
    since every f64x op is integer, proves encode_sf is bit-exact on ANY
    backend."""
    from seal_embedded_jax.config import default_parms
    from seal_embedded_jax.ops.encode import encode, encode_sf

    P = default_parms(n, L)
    rng = np.random.default_rng(n)
    vals = rng.uniform(-1, 1, (4, n // 2)).astype(np.float32)
    pt_sf, ok_sf = jax.jit(partial(encode_sf, parms=P))(jnp.asarray(vals))
    pt, ok = jax.jit(partial(encode, parms=P))(jnp.asarray(vals))
    assert bool(np.asarray(ok_sf).all()) == bool(np.asarray(ok).all())
    assert np.array_equal(np.asarray(pt_sf), np.asarray(pt))


def test_encode_sf_golden(golden_sym):
    """encode_sf vs the C reference's conj_vals_int golden vectors."""
    from seal_embedded_jax.config import default_parms
    from seal_embedded_jax.ops.encode import encode_sf

    P = default_parms(4096, 3)
    vs = np.stack([t["v"] for t in golden_sym["tests"]])
    pt, ok = jax.jit(partial(encode_sf, parms=P))(jnp.asarray(vs))
    assert bool(np.asarray(ok).all())
    for i, t in enumerate(golden_sym["tests"]):
        assert np.array_equal(np.asarray(pt)[i], t["pt"]), f"test {i}"
