"""End-to-end batched pipelines vs C-reference golden vectors (CPU backend =
IEEE f64 = fully bit-exact)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax import api
from seal_embedded_jax.config import default_parms
from seal_embedded_jax.ckks.sym import make_decryptor, make_sym_encryptor
from seal_embedded_jax.ckks.asym import make_asym_encryptor, gen_pk_batch
from seal_embedded_jax.ops import keccak as kc
from seal_embedded_jax.ops.encode import decode, encode

from conftest import seed_bytes

P = default_parms(4096, 3)
N = P.degree


def test_encode_bit_exact(golden_sym):
    vs = np.stack([t["v"] for t in golden_sym["tests"]])
    pt, ok = jax.jit(partial(encode, parms=P))(jnp.asarray(vs))
    assert bool(np.asarray(ok).all())
    for i, t in enumerate(golden_sym["tests"]):
        assert np.array_equal(np.asarray(pt)[i], t["pt"]), f"test {i}"


def test_sym_pipeline_bit_exact(golden_sym):
    sk_packed = golden_sym["sk_packed"]
    sk_signed = np.array(
        [((sk_packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1 for i in range(N)],
        dtype=np.int32)
    tests = golden_sym["tests"]
    vs = np.stack([t["v"] for t in tests])
    B = vs.shape[0]
    share = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(2)), (B, 1)))
    err = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(3)), (B, 1)))
    out = make_sym_encryptor(P)(
        jnp.asarray(vs), jnp.asarray(sk_signed), share, err)
    assert bool(np.asarray(out["ok"]).all())
    c0 = np.asarray(out["c0"])
    c1 = np.asarray(out["c1"])
    for b, t in enumerate(tests):
        assert np.array_equal(np.asarray(out["pte"])[b], t["pte"]), f"pte {b}"
        for i in range(P.nprimes):
            assert np.array_equal(c0[i, b], t["c0"][i]), f"c0 t{b} p{i}"
            assert np.array_equal(c1[i, b], t["c1"][i]), f"c1 t{b} p{i}"


def test_sym_limbscan_both_layouts(golden_sym):
    """Limb-scan pipeline: 'reference' layout must be bit-exact vs C golden
    vectors; 'parallel' layout must decrypt to the same pte."""
    from seal_embedded_jax.ckks.limbwise import make_limbscan_encryptor
    sk_packed = golden_sym["sk_packed"]
    sk_signed = np.array(
        [((sk_packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1 for i in range(N)],
        dtype=np.int32)
    tests = golden_sym["tests"]
    vs = np.stack([t["v"] for t in tests])
    B = vs.shape[0]
    share = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(2)), (B, 1)))
    err = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(3)), (B, 1)))

    out = make_limbscan_encryptor(P, "reference")(
        jnp.asarray(vs), jnp.asarray(sk_signed), share, err)
    assert bool(np.asarray(out["ok"]).all())
    for b, t in enumerate(tests):
        for i in range(P.nprimes):
            assert np.array_equal(np.asarray(out["c0"])[i, b], t["c0"][i])
            assert np.array_equal(np.asarray(out["c1"])[i, b], t["c1"][i])

    outp = make_limbscan_encryptor(P, "parallel")(
        jnp.asarray(vs), jnp.asarray(sk_signed), share, err)
    assert bool(np.asarray(outp["ok"]).all())
    cen = np.asarray(make_decryptor(P)(outp["c0"], outp["c1"],
                                       jnp.asarray(sk_signed)))
    for i in range(P.nprimes):
        assert np.array_equal(cen[i], np.asarray(outp["pte"]))


def test_sym_decrypt_decode_roundtrip():
    ctx = api.se_setup_default(api.SYM, sk_seed=b"test-sk")
    rng = np.random.default_rng(0)
    vals = rng.uniform(-1, 1, (6, N // 2)).astype(np.float32)
    out = api.se_encrypt_seeded(ctx, vals,
                                share_seeds=[seed_bytes(20 + i) for i in range(6)],
                                seeds=[seed_bytes(30 + i) for i in range(6)])
    assert bool(np.asarray(out["ok"]).all())
    dec = api.se_decrypt_decode(ctx, out)
    assert np.abs(dec - vals).max() < 0.1
    # exact pte recovery on every prime
    cen = np.asarray(make_decryptor(P)(out["c0"], out["c1"],
                                       jnp.asarray(ctx.sk_signed)))
    for i in range(P.nprimes):
        assert np.array_equal(cen[i], np.asarray(out["pte"]))


def test_asym_pipeline_vs_golden_model():
    """Batched asym path vs the pure-Python golden model, same seeds."""
    from seal_embedded_jax.golden import ckks as gckks
    from seal_embedded_jax.golden.prng import Prng
    from seal_embedded_jax.golden.sampling import (
        sample_poly_cbd_16, sample_small_poly_ternary_96, ternary_signed)

    sk_packed = sample_small_poly_ternary_96(N, Prng(seed_bytes(1)))
    sk_signed = np.array(ternary_signed(sk_packed, N), dtype=np.int32)

    ep = np.array(sample_poly_cbd_16(N, Prng(seed_bytes(40))), dtype=np.int32)
    pk0, pk1 = gen_pk_batch(jnp.asarray(sk_signed),
                            jnp.asarray(kc.seed_to_words(seed_bytes(41))[None, :]),
                            jnp.asarray(ep), P)

    gpk = gckks.gen_pk(P, sk_packed, seed=seed_bytes(41), ep=ep.tolist())
    for i in range(P.nprimes):
        assert np.asarray(pk0)[i].tolist() == gpk.components[i][0]
        assert np.asarray(pk1)[i].tolist() == gpk.components[i][1]

    vals = ((np.arange(N // 2) % 13) / 13.0).astype(np.float32)
    out = make_asym_encryptor(P)(
        jnp.asarray(vals[None, :]), pk0, pk1,
        jnp.asarray(kc.seed_to_words(seed_bytes(42))[None, :]))
    assert bool(np.asarray(out["ok"]).all())

    gct = gckks.asym_encrypt(P, vals, gpk, seed=seed_bytes(42))
    for i in range(P.nprimes):
        assert np.asarray(out["c0"])[i, 0].tolist() == gct.components[i][0], f"c0 p{i}"
        assert np.asarray(out["c1"])[i, 0].tolist() == gct.components[i][1], f"c1 p{i}"

    dec = gckks.decrypt_decode(P, gct, sk_packed)
    assert np.abs(dec - vals).max() < 0.1


def test_decode_op_roundtrip():
    from seal_embedded_jax.ops.encode import make_decoder
    rng = np.random.default_rng(5)
    vals = rng.uniform(-2, 2, (2, N // 2)).astype(np.float32)
    pt, ok = jax.jit(partial(encode, parms=P))(jnp.asarray(vals))
    dec = np.asarray(make_decoder(P)(pt))
    assert np.abs(dec - vals).max() < 1e-4
