"""SEAL 3.7.2 native stream format (io/sealstream.py): per-field
structural checks + round trips, and the full str_*.h header set.

SEAL itself is not buildable offline (the adapter FetchContents it), so
fidelity is established field-by-field against the cited 3.7.2 source
layout and exercised by round-trip here (the documented fallback
strategy; sealstream.py module docstring)."""

import struct

import numpy as np
import pytest

from seal_embedded_jax.config import default_parms
from seal_embedded_jax.io import sealstream as ss

from conftest import seed_bytes

P = default_parms(4096, 3)


def test_seal_header_layout():
    h = ss.SEALHeader(compr_mode=0, size=0x1234).pack()
    assert len(h) == 16
    # magic 0xA15E LE, header size 0x10, version 3.7, compr none,
    # reserved 0, u64 size (seal/serialization.h SEALHeader).
    assert h[:2] == b"\x5e\xa1"
    assert h[2] == 0x10
    assert (h[3], h[4]) == (3, 7)
    assert h[5] == 0
    assert h[6:8] == b"\x00\x00"
    assert struct.unpack("<Q", h[8:])[0] == 0x1234
    back = ss.SEALHeader.unpack(h)
    assert back.size == 0x1234 and back.compr_mode == 0


def test_special_prime_selection():
    """CoeffModulus::Create semantics: largest prime == 1 mod 2n below
    2^bits, stepping down by 2n (seal/util/numth.cpp get_primes)."""
    for n, bits in ((2048, 27), (4096, 19), (8192, 38), (16384, 48)):
        (p,) = ss.seal_create_prime(n, bits)
        assert p % (2 * n) == 1
        assert p < (1 << bits)
        # nothing larger in the progression is prime
        cand = p + 2 * n
        while cand < (1 << bits):
            assert not ss._is_prime(cand)
            cand += 2 * n


def test_key_context_moduli():
    kmods = ss.key_context_moduli(P)
    assert kmods[:3] == [int(q) for q in P.moduli]
    assert len(kmods) == 4  # + 19-bit special prime (adapter.cpp:196-231)
    assert kmods[3] < (1 << 19) and kmods[3] % 8192 == 1


def test_parms_id_is_blake2xb_of_param_words():
    kmods = ss.key_context_moduli(P)
    pid = ss.parms_id(P.degree, kmods)
    assert len(pid) == 32
    words = [ss.SCHEME_CKKS, P.degree] + kmods + [0]
    manual = ss.blake2xb(
        b"".join(struct.pack("<Q", w) for w in words), 32)
    assert pid == manual
    # sensitive to every parameter
    assert pid != ss.parms_id(P.degree, kmods[:-1] + [kmods[-1] + 8192])


def test_blake2b_core_vs_hashlib():
    """The hand-rolled compression core (used for the depth=0 BLAKE2X
    output nodes hashlib can't express) must match hashlib's blake2b on
    plain sequential hashing."""
    import hashlib
    for msg in (b"", b"abc", b"x" * 127, b"y" * 128, b"z" * 300,
                bytes(range(256))):
        for ds in (64, 32, 20):
            assert ss._blake2b_ref(msg, ds) == hashlib.blake2b(
                msg, digest_size=ds).digest(), (len(msg), ds)


def test_blake2xb_against_blake2b_structure():
    """For outputs <= 64 bytes blake2xb is root-hash + one final node;
    check determinism, length handling, and domain separation."""
    a = ss.blake2xb(b"seal", 32)
    b = ss.blake2xb(b"seal", 32)
    c = ss.blake2xb(b"seal", 31)
    d = ss.blake2xb(b"seam", 32)
    assert a == b and len(a) == 32 and len(c) == 31
    assert a[:31] != c and a != d
    long = ss.blake2xb(b"seal", 200)
    assert len(long) == 200 and long[:32] != a  # different xof_length


def test_secret_key_stream_roundtrip():
    rng = np.random.default_rng(0)
    kmods = ss.key_context_moduli(P)
    sk_ntt = np.stack([
        rng.integers(0, q, P.degree).astype(np.uint64) for q in kmods])
    blob = ss.save_secret_key(P, sk_ntt)
    hdr = ss.SEALHeader.unpack(blob)
    assert hdr.size == len(blob)
    back = ss.load_secret_key(P, blob)
    assert np.array_equal(back, sk_ntt)


def test_public_key_stream_roundtrip():
    rng = np.random.default_rng(1)
    kmods = ss.key_context_moduli(P)
    pk0 = np.stack([rng.integers(0, q, P.degree).astype(np.uint64)
                    for q in kmods])
    pk1 = np.stack([rng.integers(0, q, P.degree).astype(np.uint64)
                    for q in kmods])
    blob = ss.save_public_key(P, pk0, pk1)
    b0, b1 = ss.load_public_key(P, blob)
    assert np.array_equal(b0, pk0) and np.array_equal(b1, pk1)
    # field probe: is_ntt_form byte right after the 32-byte parms_id
    members = blob[16:]
    assert members[32] == 1


def test_adapter_emits_seal_streams_and_headers(tmp_path):
    from seal_embedded_jax import adapter
    out = adapter.gen_save_all(str(tmp_path), degree=4096, nprimes=3,
                               sk_seed=seed_bytes(1), pk_seed=seed_bytes(41))
    n = 4096
    # SEAL streams load back
    sk_ntt = ss.load_secret_key(P, (tmp_path / f"sk_seal_{n}.dat")
                                .read_bytes())
    assert sk_ntt.shape == (4, n)
    pk0, pk1 = ss.load_public_key(P, (tmp_path / f"pk_seal_{n}.dat")
                                  .read_bytes())
    # device-prime components identical to the .dat pk
    from seal_embedded_jax.io import serialize
    for i, q in enumerate(P.moduli):
        want0 = serialize.read_pk_component(str(tmp_path), 0, n, q)
        assert np.array_equal(pk0[i].astype(np.uint32), want0)
    # special-prime component is in range and nonzero
    sp = ss.key_context_moduli(P)[3]
    assert pk0[3].max() < sp and pk0[3].any()
    # sk stream consistent with the packed sk: ntt(s) mod q0 matches
    from seal_embedded_jax.golden.ntt import ntt_inpl
    from seal_embedded_jax.golden.sampling import expand_poly_ternary
    from seal_embedded_jax.config import find_ntt_root
    q0 = int(P.moduli[0])
    s = expand_poly_ternary(out["sk_packed"], n, q0)
    want = ntt_inpl(s, n, P.logn, q0, find_ntt_root(n, q0))
    assert sk_ntt[0].tolist() == want

    # full str header set (fileops.cpp:173-304)
    addr = (tmp_path / "str_pk_addr_array.h").read_text()
    assert "ZZ* pk_prime_addr[3][2]" in addr
    for t, q in enumerate(P.moduli):
        for k in (0, 1):
            h = (tmp_path / f"str_pk{k}_ntt_{n}_{int(q)}.h").read_text()
            assert f"ZZ pk{k}_prime{t}[{n}]" in h
            assert f'#include "str_pk{k}_ntt_{n}_{int(q)}.h"' in addr
    skh = (tmp_path / f"str_sk_{n}.h").read_text()
    assert f"uint8_t secret_key[{n // 4}]" in skh


def test_ciphertext_stream_roundtrip():
    """Device-produced ct as a SEAL Ciphertext stream under the DATA
    context (fresh cts live at first_context_data; adapter ct loader
    fileops.cpp:492-538) — save -> load bit-round-trip, scale carried,
    wrong-chain parms_id rejected."""
    parms = default_parms(4096, 3)
    rng = np.random.default_rng(5)
    L, n = parms.nprimes, parms.degree
    c0 = np.stack([rng.integers(0, int(q), n).astype(np.uint32)
                   for q in parms.moduli])
    c1 = np.stack([rng.integers(0, int(q), n).astype(np.uint32)
                   for q in parms.moduli])
    blob = ss.save_ciphertext(parms, c0, c1)
    # well-formed doubly-wrapped stream: outer header size == len
    hdr = ss.SEALHeader.unpack(blob)
    assert hdr.size == len(blob)
    g0, g1, scale = ss.load_ciphertext(parms, blob)
    assert np.array_equal(g0, c0.astype(np.uint64))
    assert np.array_equal(g1, c1.astype(np.uint64))
    assert scale == parms.scale
    # a truncated chain must be rejected by the embedded parms_id
    with pytest.raises(AssertionError, match="parms_id"):
        ss.load_ciphertext(default_parms(4096, 2), blob)


def test_ciphertext_vs_public_key_layout_share_core():
    """pk and ct streams use the identical Ciphertext member layout (the
    SEAL invariant PublicKey wraps a Ciphertext): byte offsets of the
    shared fields line up."""
    parms = default_parms(4096, 3)
    kmods = ss.key_context_moduli(parms)
    rng = np.random.default_rng(6)
    n = parms.degree
    pk = [np.stack([rng.integers(0, int(q), n).astype(np.uint64)
                    for q in kmods]) for _ in range(2)]
    blob_pk = ss.save_public_key(parms, pk[0], pk[1])
    blob_ct = ss.save_ciphertext(parms, pk[0][:3].astype(np.uint32),
                                 pk[1][:3].astype(np.uint32))
    # both parse with the same member parser (implicitly shared), and the
    # fixed-width header region (after parms_id) has the same layout
    for blob, L in ((blob_pk, len(kmods)), (blob_ct, 3)):
        members = blob[16:]
        is_ntt, = struct.unpack("<B", members[32:33])
        size, pn, pl = struct.unpack("<QQQ", members[33:57])
        assert (is_ntt, size, pn, pl) == (1, 2, n, L)
