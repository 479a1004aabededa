"""Golden (NumPy) model vs bit-exact vectors captured from the C reference.

The npz fixture was produced by golden/golden_driver.c linking the unmodified
reference library (seeds: tag1=sk, tag2=shareable, tag3=error; see
tests/conftest.py).
"""

import numpy as np
import pytest

from seal_embedded_jax.config import default_parms, const_ratio
from seal_embedded_jax.golden import ckks
from seal_embedded_jax.golden.encode import encode_base
from seal_embedded_jax.golden.keccak import shake256, shake256_hashlib
from seal_embedded_jax.golden.ntt import intt_inpl, ntt_inpl, poly_mult_sb_negacyclic
from seal_embedded_jax.golden.prng import Prng
from seal_embedded_jax.golden.sampling import (
    expand_poly_ternary, sample_add_poly_cbd_16, sample_poly_uniform,
    sample_small_poly_ternary_96)

from conftest import seed_bytes

P = default_parms(4096, 3)
N, LOGN = P.degree, P.logn


def test_shake256_self():
    for ln in (0, 1, 71, 72, 135, 136, 137, 1000):
        d = bytes(range(min(ln, 256)))[:ln] if ln <= 256 else b"x" * ln
        assert shake256(d, 300) == shake256_hashlib(d, 300)


def test_const_ratio_matches_reference_table():
    # Spot values from modulus.c:30-47.
    assert const_ratio(1053818881) == (0x135BF4BA, 0x4)
    assert const_ratio(1062535169) == (0xACCDB49, 0x4)
    assert const_ratio(134012929) == (0xC84DFE5, 0x20)


def test_ntt_roots_are_primitive():
    for q in P.moduli:
        w = P.ntt_root(q)
        assert pow(w, 2 * N, q) == 1
        assert pow(w, N, q) == q - 1


def test_ntt_intt_roundtrip():
    rng = np.random.default_rng(0)
    q = P.moduli[0]
    a = rng.integers(0, q, N).tolist()
    back = intt_inpl(ntt_inpl(a, N, LOGN, q, P.ntt_root(q)), N, LOGN, q,
                     P.ntt_root(q))
    assert back == a


def test_ntt_vs_schoolbook_small():
    from seal_embedded_jax.config import NTT_ROOTS
    n, logn, q = 1024, 10, 134012929
    w = NTT_ROOTS[(n, q)]
    rng = np.random.default_rng(1)
    a = rng.integers(0, q, n).tolist()
    b = rng.integers(0, q, n).tolist()
    na, nb = ntt_inpl(a, n, logn, q, w), ntt_inpl(b, n, logn, q, w)
    prod = [(x * y) % q for x, y in zip(na, nb)]
    assert intt_inpl(prod, n, logn, q, w) == poly_mult_sb_negacyclic(a, b, q)


def test_sk_matches_reference(golden_sym):
    sk = sample_small_poly_ternary_96(N, Prng(seed_bytes(1)))
    assert sk == golden_sym["sk_packed"]


@pytest.mark.parametrize("tn", range(6))
def test_full_sym_pipeline_bit_exact(golden_sym, tn):
    t = golden_sym["tests"][tn]
    sk = golden_sym["sk_packed"]

    pt = encode_base(P, t["v"])
    assert np.array_equal(pt, t["pt"])

    pte = np.array(sample_add_poly_cbd_16(pt.tolist(), Prng(seed_bytes(3))),
                   dtype=np.int64)
    assert np.array_equal(pte, t["pte"])

    share = Prng(seed_bytes(2))
    for i, q in enumerate(P.moduli):
        w = P.ntt_root(q)
        c1 = sample_poly_uniform(N, q, share)
        assert c1 == t["c1"][i].tolist()
        s = expand_poly_ternary(sk, N, q)
        ntt_s = ntt_inpl(s, N, LOGN, q, w)
        c0 = [(q - (x * y) % q) % q for x, y in zip(ntt_s, c1)]
        ntt_pte = ntt_inpl(ckks.reduce_pte(pte, q), N, LOGN, q, w)
        c0 = [(x + y) % q for x, y in zip(c0, ntt_pte)]
        assert c0 == t["c0"][i].tolist()


def test_decrypt_decode_roundtrip(golden_sym):
    t = golden_sym["tests"][3]
    sk = golden_sym["sk_packed"]
    for i in range(P.nprimes):
        cen = ckks.decrypt_component(P, i, t["c0"][i].tolist(),
                                     t["c1"][i].tolist(), sk)
        assert np.array_equal(cen, t["pte"])
    from seal_embedded_jax.golden.encode import decode
    dec = decode(P, ckks.decrypt_component(P, 0, t["c0"][0].tolist(),
                                           t["c1"][0].tolist(), sk))
    assert np.abs(dec - t["v"]).max() < 0.1


def test_asym_golden_roundtrip():
    sk = sample_small_poly_ternary_96(N, Prng(b"sk"))
    vals = (np.arange(N // 2) % 31).astype(np.float32) / 31.0
    pk = ckks.gen_pk(P, sk, seed=b"pk")
    ct = ckks.asym_encrypt(P, vals, pk, seed=b"u")
    dec = ckks.decrypt_decode(P, ct, sk)
    assert np.abs(dec - vals).max() < 0.1
