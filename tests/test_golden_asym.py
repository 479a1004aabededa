"""Asymmetric (public-key) pipeline vs C-reference golden vectors.

Vectors captured from golden/golden_driver.c (asym mode): deterministic
seeds sk=tag1, err=tag3, pk=tag4 (ep printed explicitly), six message
patterns, n=4096, 3 primes.  Bit-exact on the CPU backend (IEEE f64).
Reference pipeline: ckks_asym.c:159-286, seal_embedded.c asym path.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax.ckks.asym import (asym_encrypt_fused, gen_pk_batch,
                                         make_asym_encryptor)
from seal_embedded_jax.config import default_parms
from seal_embedded_jax.ops import keccak as kc

from conftest import seed_bytes

P = default_parms(4096, 3)
N = P.degree


@pytest.fixture(scope="module")
def golden_asym():
    data = np.load(pathlib.Path(__file__).parent / "golden_asym_4096_3.npz")
    ntests = sum(1 for k in data.files if k.startswith("v_"))
    # Limb count inferred from the npz itself (not hardcoded) so vectors
    # regenerated with a different prime chain fail loudly, not confusingly.
    L = sum(1 for k in data.files if k.startswith("pk0_"))
    assert L * ntests == sum(1 for k in data.files if k.startswith("c0_"))
    tests = []
    for t in range(ntests):
        tests.append({
            "v": data[f"v_{t}"],
            "pt": data[f"pt_{t}"],
            "pte": data[f"pte_{t}"],
            "u_packed": data[f"u_packed_{t}"],
            "e1": data[f"e1_{t}"],
            "c0": [data[f"c0_{L * t + i}"] for i in range(L)],
            "c1": [data[f"c1_{L * t + i}"] for i in range(L)],
        })
    return {
        "sk_packed": bytes(data["sk_packed_0"].tolist()),
        "ep": data["pk_ep"],
        "pk0": [data[f"pk0_{i}"] for i in range(L)],
        "pk1": [data[f"pk1_{i}"] for i in range(L)],
        "tests": tests,
    }


def _sk_signed(sk_packed):
    return np.array(
        [((sk_packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1 for i in range(N)],
        dtype=np.int32)


def test_gen_pk_bit_exact(golden_asym):
    """Device-side pk generation matches the C reference limb by limb."""
    sk_signed = _sk_signed(golden_asym["sk_packed"])
    pk0, pk1 = gen_pk_batch(
        jnp.asarray(sk_signed),
        jnp.asarray(kc.seed_to_words(seed_bytes(4))[None, :]),
        jnp.asarray(golden_asym["ep"].astype(np.int32)), P)
    for i in range(P.nprimes):
        assert np.array_equal(np.asarray(pk0)[i], golden_asym["pk0"][i]), i
        assert np.array_equal(np.asarray(pk1)[i], golden_asym["pk1"][i]), i


def test_asym_pipeline_bit_exact(golden_asym):
    """Batched asym encode+encrypt == C reference, all tests/primes."""
    tests = golden_asym["tests"]
    vs = np.stack([t["v"] for t in tests])
    B = vs.shape[0]
    pk0 = jnp.asarray(np.stack(golden_asym["pk0"]))
    pk1 = jnp.asarray(np.stack(golden_asym["pk1"]))
    err = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(3)), (B, 1)))

    out = make_asym_encryptor(P)(jnp.asarray(vs), pk0, pk1, err)
    assert bool(np.asarray(out["ok"]).all())
    c0 = np.asarray(out["c0"])
    c1 = np.asarray(out["c1"])
    for b, t in enumerate(tests):
        assert np.array_equal(np.asarray(out["pt"])[b], t["pt"]), f"pt {b}"
        assert np.array_equal(np.asarray(out["pte"])[b], t["pte"]), f"pte {b}"
        for i in range(P.nprimes):
            assert np.array_equal(c0[i, b], t["c0"][i]), f"c0 t{b} p{i}"
            assert np.array_equal(c1[i, b], t["c1"][i]), f"c1 t{b} p{i}"


def test_asym_fused_bit_exact(golden_asym):
    """Fused (single Pallas NTT call) asym path == C reference."""
    import jax
    from functools import partial
    tests = golden_asym["tests"][:2]
    vs = np.stack([t["v"] for t in tests])
    B = vs.shape[0]
    pk0 = jnp.asarray(np.stack(golden_asym["pk0"]))
    pk1 = jnp.asarray(np.stack(golden_asym["pk1"]))
    err = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(3)), (B, 1)))

    out = jax.jit(partial(asym_encrypt_fused, parms=P, encode_mode="f64"))(
        jnp.asarray(vs), pk0, pk1, err)
    assert bool(np.asarray(out["ok"]).all())
    for b, t in enumerate(tests):
        for i in range(P.nprimes):
            assert np.array_equal(np.asarray(out["c0"])[i, b], t["c0"][i])
            assert np.array_equal(np.asarray(out["c1"])[i, b], t["c1"][i])
