"""Fused pipelines (the api's encrypt path) vs the reference-layout pipelines.

Equality here proves the graph restructuring (stacked all-limb NTT,
limb-decoupled arithmetic) preserves values; the SHAKE kernel the fused
paths use on a GPU is covered in interpret mode by test_keccak_kernel.py
and compiled by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax.config import Parms, PRIMES_27BIT

P1K = Parms(degree=1024, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)


def _inputs(B, n, seed=0):
    rng = np.random.default_rng(seed)
    values = jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32))
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    share = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))
    err = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))
    return values, sk, share, err


def test_sym_fused_matches_limbwise():
    from functools import partial
    from seal_embedded_jax.ckks.fast import sym_encrypt_fused
    from seal_embedded_jax.ckks.limbwise import sym_encrypt_limbscan

    values, sk, share, err = _inputs(3, P1K.degree)
    fused = jax.jit(partial(sym_encrypt_fused, parms=P1K,
                            encode_mode="f64"))(values, sk, share, err)
    ref = jax.jit(partial(sym_encrypt_limbscan, parms=P1K,
                          layout="reference",
                          encode_mode="f64"))(values, sk, share, err)
    assert bool(np.asarray(fused["ok"]).all())
    for k in ("c0", "c1", "pte"):
        assert np.array_equal(np.asarray(fused[k]), np.asarray(ref[k])), k


def test_asym_fused_matches_batch():
    from functools import partial
    from seal_embedded_jax.ckks.asym import (
        asym_encrypt_batch, asym_encrypt_fused, gen_pk_batch)

    n = P1K.degree
    rng = np.random.default_rng(7)
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    ep = jnp.asarray(rng.integers(-20, 21, n).astype(np.int32))
    pkseed = jnp.asarray(rng.integers(0, 2 ** 32, (1, 16)).astype(np.uint32))
    pk0, pk1 = gen_pk_batch(sk, pkseed, ep, P1K)

    values, _, share, _ = _inputs(3, n, seed=8)
    fused = jax.jit(partial(asym_encrypt_fused, parms=P1K,
                            encode_mode="f64"))(values, pk0, pk1, share)
    ref = jax.jit(partial(asym_encrypt_batch, parms=P1K,
                          encode_mode="f64"))(values, pk0, pk1, share)
    assert bool(np.asarray(fused["ok"]).all())
    for k in ("c0", "c1", "pte"):
        assert np.array_equal(np.asarray(fused[k]), np.asarray(ref[k])), k


def test_encode_dd_decode_exact():
    """dd encode is not bit-exact vs f64 but must round-trip decode well
    inside the 0.1 tolerance (README bit-exactness strategy, item 4)."""
    from functools import partial
    from seal_embedded_jax.ops.encode import encode, encode_dd, make_decoder

    rng = np.random.default_rng(3)
    vals = rng.uniform(-2, 2, (2, P1K.degree // 2)).astype(np.float32)
    pt_dd, ok = jax.jit(partial(encode_dd, parms=P1K))(jnp.asarray(vals))
    assert bool(np.asarray(ok).all())
    dec = np.asarray(make_decoder(P1K)(pt_dd))
    assert np.abs(dec - vals).max() < 1e-3
    pt64, _ = jax.jit(partial(encode, parms=P1K))(jnp.asarray(vals))
    # dd coefficients stay within a tiny absolute distance of IEEE f64's.
    assert np.abs(np.asarray(pt_dd) - np.asarray(pt64)).max() <= 1
