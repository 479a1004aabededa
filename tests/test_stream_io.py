"""Per-prime streaming mode + file-loader parity (fileops.c load_* family)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax import api
from seal_embedded_jax.config import Parms, PRIMES_27BIT, default_parms
from seal_embedded_jax.io import serialize

from conftest import seed_bytes

P = Parms(degree=1024, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)


def test_streaming_matches_limbscan():
    from seal_embedded_jax.ckks.limbwise import make_limbscan_encryptor
    from seal_embedded_jax.ckks.stream import sym_encrypt_stream
    from seal_embedded_jax.ops.keccak import seed_to_words

    rng = np.random.default_rng(0)
    B, n = 2, P.degree
    values = jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32))
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    share = jnp.asarray(np.tile(seed_to_words(seed_bytes(2)), (B, 1)))
    err = jnp.asarray(np.tile(seed_to_words(seed_bytes(3)), (B, 1)))

    ref = make_limbscan_encryptor(P)(values, sk, share, err)
    limbs = list(sym_encrypt_stream(values, sk, share, err, P))
    assert [l["prime_idx"] for l in limbs] == [0, 1]
    for i, l in enumerate(limbs):
        assert np.array_equal(l["c0"], np.asarray(ref["c0"])[i]), f"c0 {i}"
        assert np.array_equal(l["c1"], np.asarray(ref["c1"])[i]), f"c1 {i}"


def test_asym_streaming_matches_batch():
    """Per-prime asym streaming (ckks_next_prime_asym analog) ==
    the batch asym pipeline (itself golden-anchored), limb by limb."""
    from seal_embedded_jax.ckks.asym import gen_pk_batch, make_asym_encryptor
    from seal_embedded_jax.ckks.stream import asym_encrypt_stream
    from seal_embedded_jax.ops.keccak import seed_to_words

    rng = np.random.default_rng(7)
    B, n = 2, P.degree
    values = jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32))
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    ep = jnp.asarray(rng.integers(-20, 21, n).astype(np.int32))
    pk_seed = jnp.asarray(np.tile(seed_to_words(seed_bytes(4)), (1, 1)))
    pk0, pk1 = gen_pk_batch(sk, pk_seed, ep, P)
    seeds = jnp.asarray(np.tile(seed_to_words(seed_bytes(3)), (B, 1)))

    ref = make_asym_encryptor(P)(values, pk0, pk1, seeds)
    limbs = list(asym_encrypt_stream(values, pk0, pk1, seeds, P))
    assert [l["prime_idx"] for l in limbs] == [0, 1]
    for i, l in enumerate(limbs):
        assert np.array_equal(l["c0"], np.asarray(ref["c0"])[i]), f"c0 {i}"
        assert np.array_equal(l["c1"], np.asarray(ref["c1"])[i]), f"c1 {i}"
    limbs_r = list(asym_encrypt_stream(values, pk0, pk1, seeds, P,
                                       order="reverse"))
    assert [l["prime_idx"] for l in limbs_r] == [1, 0]
    assert np.array_equal(limbs_r[0]["c0"], limbs[1]["c0"])


def test_streaming_reverse_order():
    from seal_embedded_jax.ckks.stream import sym_encrypt_stream
    from seal_embedded_jax.ops.keccak import seed_to_words

    rng = np.random.default_rng(1)
    B, n = 1, P.degree
    values = jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32))
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    share = jnp.asarray(np.tile(seed_to_words(seed_bytes(4)), (B, 1)))
    err = jnp.asarray(np.tile(seed_to_words(seed_bytes(5)), (B, 1)))
    limbs = list(sym_encrypt_stream(values, sk, share, err, P,
                                    order="reverse"))
    assert [l["prime_idx"] for l in limbs] == [1, 0]


def test_lazy_intt_loaded_fast_tables(tmp_path):
    """Decrypt oracle via the reference's lazy INTT (intt_lazy_inpl,
    intt.c:72-129) CONSUMING loaded intt_fast_roots_*.dat files ==
    canonical INTT decrypt, bit for bit."""
    from seal_embedded_jax.ckks.limbwise import make_limbscan_encryptor
    from seal_embedded_jax.ckks.sym import decrypt_batch
    from seal_embedded_jax.io import serialize
    from seal_embedded_jax.ops.keccak import seed_to_words

    rng = np.random.default_rng(11)
    B, n = 2, P.degree
    values = jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32))
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    share = jnp.asarray(np.tile(seed_to_words(seed_bytes(2)), (B, 1)))
    err = jnp.asarray(np.tile(seed_to_words(seed_bytes(3)), (B, 1)))
    out = make_limbscan_encryptor(P)(values, sk, share, err)

    serialize.write_intt_roots(str(tmp_path), P, fast=True)
    loaded = {}
    for q in P.moduli:
        q = int(q)
        pairs = serialize.read_ntt_roots(
            str(tmp_path / f"intt_fast_roots_{n}_{q}.dat"), n, fast=True)
        loaded[q] = (pairs[:, 0].copy(), pairs[:, 1].copy())

    want = decrypt_batch(out["c0"], out["c1"], sk, P)
    got = decrypt_batch(out["c0"], out["c1"], sk, P,
                        intt_impl="lazy", loaded_intt=loaded)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    # and the decrypt really inverts: centered pte == pipeline pte mod q
    assert np.array_equal(
        np.asarray(got)[0] % int(P.moduli[0]),
        np.asarray(out["pte"]) % int(P.moduli[0]))


def test_file_loaders_roundtrip(tmp_path):
    from seal_embedded_jax.ops.encode import (ifft_root_tables, index_map_np)
    from seal_embedded_jax.ops.ntt import ntt_tables

    n, logn = P.degree, P.logn
    q = int(P.moduli[0])

    imap_path = str(tmp_path / f"index_map_{n}.dat")
    serialize.write_index_map(imap_path, index_map_np(n))
    assert np.array_equal(serialize.read_index_map(imap_path, n),
                          index_map_np(n))

    roots_path = str(tmp_path / f"ifft_roots_{n}.dat")
    serialize.write_ifft_roots(roots_path, n, logn)
    r = serialize.read_ifft_roots(roots_path, n)
    assert r.shape == (2 * n,)
    # every root lies on the unit circle
    mag = r[0::2] ** 2 + r[1::2] ** 2
    assert np.abs(mag - 1.0).max() < 1e-12

    for fast in (False, True):
        w = P.ntt_root(q)
        name = f"ntt_{'fast_' if fast else ''}roots_{n}_{q}.dat"
        path = str(tmp_path / name)
        if fast:
            serialize.ntt_fast_root_table(n, logn, q, w).astype(
                "<u4").tofile(path)
        else:
            serialize.ntt_root_table(n, logn, q, w).astype(
                "<u4").tofile(path)
        tbl = serialize.read_ntt_roots(path, n, fast=fast)
        op_want, quot_want = ntt_tables(n, q)
        if fast:
            assert np.array_equal(tbl[:, 0], op_want)
            assert np.array_equal(tbl[:, 1], quot_want)
        else:
            assert np.array_equal(tbl, op_want)


def test_ntt_from_file_tables(tmp_path):
    """NTT driven by file-loaded MUMO tables == computed-table NTT — the
    reference's SE_NTT_TYPE=3 'load fast roots' mode (user_defines.h:80)."""
    from seal_embedded_jax.ops.ntt import ntt, ntt_with_tables

    n, logn = P.degree, P.logn
    q = int(P.moduli[0])
    path = str(tmp_path / "fast.dat")
    serialize.ntt_fast_root_table(n, logn, q, P.ntt_root(q)).astype(
        "<u4").tofile(path)
    tbl = serialize.read_ntt_roots(path, n, fast=True)

    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.integers(0, q, (2, n)).astype(np.uint32))
    got = ntt_with_tables(x, jnp.asarray(tbl[:, 0].astype(np.uint32)),
                          jnp.asarray(tbl[:, 1].astype(np.uint32)), q)
    assert np.array_equal(np.asarray(got), np.asarray(ntt(x, q)))


def test_ifft_loaded_roots_drive_encode(tmp_path):
    """SE_IFFT_LOAD_FULL parity: a written roots file, reloaded, yields
    per-round tables bit-identical to the computed ones AND drives encode
    to bit-identical plaintexts."""
    import jax.numpy as jnp
    from seal_embedded_jax.config import Parms, PRIMES_27BIT
    from seal_embedded_jax.io.serialize import write_ifft_roots
    from seal_embedded_jax.ops.encode import (encode, ifft_root_tables,
                                              ifft_root_tables_from_file)

    n, logn = 256, 8
    path = str(tmp_path / f"ifft_roots_{n}.dat")
    write_ifft_roots(path, n, logn)
    loaded = ifft_root_tables_from_file(path, n)
    computed = ifft_root_tables(n)
    assert len(loaded) == len(computed) == logn
    for (lre, lim), (cre, cim) in zip(loaded, computed):
        assert np.array_equal(lre.view(np.uint64), cre.view(np.uint64))
        assert np.array_equal(lim.view(np.uint64), cim.view(np.uint64))

    parms = Parms(degree=n, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.uniform(-1, 1, (4, n // 2)).astype(np.float32))
    pt_loaded, ok1 = encode(v, parms, root_tables=loaded)
    pt_computed, ok2 = encode(v, parms)
    assert bool(np.asarray(ok1).all()) and bool(np.asarray(ok2).all())
    assert np.array_equal(np.asarray(pt_loaded), np.asarray(pt_computed))
