"""Full-degree coverage: the jnp pipeline must be bit-exact against the C
reference at every supported ring degree (1024, 8192, 16384 here; 4096 is
covered exhaustively in test_pipeline.py), including the reference's
full-depth default chains — 6 primes at n=8192 and 13 primes at n=16384
(/root/reference/device/lib/parameters.c:159-174).  Vectors from
golden_driver.c (seeds: sk=tag1, share=tag2, err=tag3)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax.ckks.limbwise import make_limbscan_encryptor
from seal_embedded_jax.config import default_parms
from seal_embedded_jax.ops import keccak as kc

from conftest import seed_bytes

GOLDEN_DIR = pathlib.Path(__file__).parent


def _load(n, nprimes):
    data = np.load(GOLDEN_DIR / f"golden_sym_{n}_{nprimes}.npz")
    ntests = sum(1 for k in data.files if k.startswith("v_"))
    tests = []
    for t in range(ntests):
        tests.append({
            "v": data[f"v_{t}"],
            "pt": data[f"pt_{t}"],
            "pte": data[f"pte_{t}"],
            "c0": [data[f"c0_{nprimes * t + i}"] for i in range(nprimes)],
            "c1": [data[f"c1_{nprimes * t + i}"] for i in range(nprimes)],
        })
    return bytes(data["sk_packed_0"].tolist()), tests


def _load_asym(n, nprimes):
    data = np.load(GOLDEN_DIR / f"golden_asym_{n}_{nprimes}.npz")
    ntests = sum(1 for k in data.files if k.startswith("v_"))
    tests = []
    for t in range(ntests):
        tests.append({
            "v": data[f"v_{t}"],
            "pte": data[f"pte_{t}"],
            "c0": [data[f"c0_{nprimes * t + i}"] for i in range(nprimes)],
            "c1": [data[f"c1_{nprimes * t + i}"] for i in range(nprimes)],
        })
    pk0 = np.stack([data[f"pk0_{i}"] for i in range(nprimes)])
    pk1 = np.stack([data[f"pk1_{i}"] for i in range(nprimes)])
    return pk0, pk1, tests


@pytest.mark.parametrize("n,nprimes,ntests", [(8192, 6, 3), (16384, 13, 2)])
def test_asym_pipeline_bit_exact_deep_chain(n, nprimes, ntests):
    """Asymmetric pipeline vs C reference at the deep default chains
    (adapter.cpp:196-231 param sets; ckks_asym.c is degree-generic).
    Vectors from golden_driver asym (seeds: sk=tag1, private=tag3,
    pk=tag4).  ntests trims batch to keep CPU runtime bounded."""
    from seal_embedded_jax.ckks.asym import make_asym_encryptor
    pk0, pk1, tests = _load_asym(n, nprimes)
    tests = tests[:ntests]
    parms = default_parms(n, nprimes)
    vs = np.stack([t["v"] for t in tests])
    B = vs.shape[0]
    seeds = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(3)), (B, 1)))
    out = make_asym_encryptor(parms)(
        jnp.asarray(vs), jnp.asarray(pk0), jnp.asarray(pk1), seeds)
    assert bool(np.asarray(out["ok"]).all())
    c0 = np.asarray(out["c0"])
    c1 = np.asarray(out["c1"])
    for b, t in enumerate(tests):
        assert np.array_equal(np.asarray(out["pte"])[b], t["pte"]), f"pte {b}"
        for i in range(nprimes):
            assert np.array_equal(c0[i, b], t["c0"][i]), f"c0 t{b} p{i}"
            assert np.array_equal(c1[i, b], t["c1"][i]), f"c1 t{b} p{i}"


@pytest.mark.parametrize("n,nprimes", [(1024, 1), (2048, 1), (8192, 3),
                                       (16384, 3), (8192, 6), (16384, 13)])
def test_sym_pipeline_bit_exact_degree(n, nprimes):
    sk_packed, tests = _load(n, nprimes)
    parms = default_parms(n, nprimes)
    sk_signed = np.array(
        [((sk_packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1 for i in range(n)],
        dtype=np.int32)
    vs = np.stack([t["v"] for t in tests])
    B = vs.shape[0]
    share = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(2)), (B, 1)))
    err = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(3)), (B, 1)))
    out = make_limbscan_encryptor(parms)(
        jnp.asarray(vs), jnp.asarray(sk_signed), share, err)
    assert bool(np.asarray(out["ok"]).all())
    c0 = np.asarray(out["c0"])
    c1 = np.asarray(out["c1"])
    for b, t in enumerate(tests):
        assert np.array_equal(np.asarray(out["pte"])[b], t["pte"]), f"pte {b}"
        for i in range(nprimes):
            assert np.array_equal(c0[i, b], t["c0"][i]), f"c0 t{b} p{i}"
            assert np.array_equal(c1[i, b], t["c1"][i]), f"c1 t{b} p{i}"
