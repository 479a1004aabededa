"""Host-side adapter: keygen, precompute-data generation, ct verification.

This framework's edition of the reference's `adapter/` program
(adapter/adapter.cpp:171-353): option 1 "generate everything" becomes
`generate`, option 2 "verify ciphertexts" becomes `verify`.  Where the
reference links Microsoft SEAL, this adapter uses the framework's own
bit-exact golden model (seal_embedded_jax.golden) — itself validated
word-for-word against the reference C library (tests/, golden/).

The generated files are byte-compatible with the reference device library's
loaders (device/lib/fileops.c:140-392), so an unmodified SEAL-Embedded
build can consume keys produced here — the reverse-direction
interoperability check used by .claude/skills/verify.

Usage:
    python -m seal_embedded_jax.adapter generate --out DIR [--degree 4096]
        [--nprimes 3] [--sk-seed HEX64] [--pk-seed HEX64]
    python -m seal_embedded_jax.adapter verify --sk DIR/sk_<n>.dat CT_FILE
        [--degree 4096] [--nprimes 3] [--values VALUES_FILE]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

from .config import Parms, default_parms
from .io import serialize


def gen_save_all(outdir: str, degree: int = 4096, nprimes: int = 3,
                 sk_seed: bytes | None = None,
                 pk_seed: bytes | None = None) -> dict:
    """Generate sk, pk, index map, IFFT roots, NTT/INTT regular+fast root
    tables (adapter.cpp menu option 1; generate.h:45-102)."""
    from .golden.ckks import gen_pk
    from .golden.prng import Prng
    from .golden.sampling import sample_small_poly_ternary_96

    os.makedirs(outdir, exist_ok=True)
    parms = default_parms(degree, nprimes)
    n = degree

    # Keygen runs on the host golden model (bit-exact, no compiles):
    # keygen is a one-time offline step, not a throughput path.
    sk_seed = sk_seed or os.urandom(64)
    sk_packed = sample_small_poly_ternary_96(n, Prng(sk_seed))
    serialize.write_sk(os.path.join(outdir, f"sk_{n}.dat"), sk_packed)

    pk_seed = pk_seed or os.urandom(64)
    pk = gen_pk(parms, sk_packed, seed=pk_seed)
    serialize.write_pk(outdir, parms, pk.components)

    from .ops.encode import index_map_np
    serialize.write_index_map(
        os.path.join(outdir, f"index_map_{n}.dat"), index_map_np(n))
    serialize.write_ifft_roots(
        os.path.join(outdir, f"ifft_roots_{n}.dat"), n, parms.logn)
    serialize.write_fft_roots(
        os.path.join(outdir, f"fft_roots_{n}.dat"), n, parms.logn)
    serialize.write_ntt_roots(outdir, parms, fast=False)
    serialize.write_ntt_roots(outdir, parms, fast=True)
    serialize.write_intt_roots(outdir, parms, fast=False)
    serialize.write_intt_roots(outdir, parms, fast=True)
    # str_*.h headers: the SE_DATA_FROM_CODE_COPY consumption format —
    # the adapter's full emitted set (fileops.cpp:86-161, 173-304).
    serialize.write_sk_str_header(
        os.path.join(outdir, f"str_sk_{n}.h"), n, sk_packed)
    serialize.write_pk_str_headers(outdir, parms, pk.components)

    # SEAL 3.7.2 native streams under the key context (device chain +
    # special prime), the format fileops.cpp:379-436 saves/loads.
    _write_seal_streams(outdir, parms, sk_packed, pk, pk_seed=pk_seed)
    return {"parms": parms, "sk_packed": sk_packed, "pk": pk,
            "outdir": outdir}


def _write_seal_streams(outdir: str, parms: Parms, sk_packed: bytes,
                        pk, pk_seed: bytes | None) -> None:
    """sk/pk as SEAL-native streams (io/sealstream.py).

    The key context includes the special prime (possibly >32 bits), so
    these components are computed with the arbitrary-precision golden
    NTT.  The special-prime pk component extends the device keygen's
    counter chain with one more uniform draw (64-bit rejection sampling —
    a framework convention documented in sealstream.py; real SEAL keygen
    is not reproducible without SEAL's own PRNG)."""
    import hashlib

    from .config import find_ntt_root
    from .golden.ntt import ntt_inpl
    from .golden.prng import Prng
    from .golden.sampling import (expand_poly_ternary, sample_poly_cbd_16,
                                  sample_poly_uniform)
    from .io import sealstream as ss

    n, logn = parms.degree, parms.logn
    kmods = ss.key_context_moduli(parms)

    sk_ntt = np.zeros((len(kmods), n), dtype=np.uint64)
    for i, q in enumerate(kmods):
        w = find_ntt_root(n, q)
        s = expand_poly_ternary(sk_packed, n, q)
        sk_ntt[i] = np.array(ntt_inpl(s, n, logn, q, w), dtype=np.uint64)
    with open(os.path.join(outdir, f"sk_seal_{n}.dat"), "wb") as f:
        f.write(ss.save_secret_key(parms, sk_ntt))

    if pk is not None:
        L = parms.nprimes
        pk0 = np.zeros((len(kmods), n), dtype=np.uint64)
        pk1 = np.zeros((len(kmods), n), dtype=np.uint64)
        for i in range(L):
            pk0[i] = np.array(pk.components[i][0], dtype=np.uint64)
            pk1[i] = np.array(pk.components[i][1], dtype=np.uint64)
        if len(kmods) > L and pk_seed is not None:
            sp = kmods[L]
            w = find_ntt_root(n, sp)
            # The special-prime component continues the shareable stream
            # after the L device-prime draws (replay them to advance the
            # counter identically to golden.ckks.gen_pk).
            prng = Prng(pk_seed)
            for q in parms.moduli:
                sample_poly_uniform(n, int(q), prng)
            a = _sample_uniform_u64(prng, n, sp)
            s = expand_poly_ternary(sk_packed, n, sp)
            ntt_s = ntt_inpl(s, n, logn, sp, w)
            ep_prng = Prng(hashlib.shake_256(pk_seed + b"ep").digest(64))
            ep = sample_poly_cbd_16(n, ep_prng)
            ntt_ep = ntt_inpl([int(x) % sp for x in ep], n, logn, sp, w)
            pk0[L] = np.array(
                [(sp - (x * y) % sp + z) % sp
                 for x, y, z in zip(ntt_s, a, ntt_ep)], dtype=np.uint64)
            pk1[L] = np.array(a, dtype=np.uint64)
        with open(os.path.join(outdir, f"pk_seal_{n}.dat"), "wb") as f:
            f.write(ss.save_public_key(parms, pk0, pk1))


def _sample_uniform_u64(prng, n: int, q: int) -> list[int]:
    """Uniform mod q for a >32-bit key prime: 8-byte LE draws with
    rejection above the largest multiple of q below 2^64 (the 64-bit
    analog of sample.c:39-57)."""
    max_multiple = (1 << 64) - ((1 << 64) % q)
    out = []
    buf = b""
    while len(out) < n:
        if len(buf) < 8:
            buf += prng.fill(136)
        v = int.from_bytes(buf[:8], "little")
        buf = buf[8:]
        if v < max_multiple:
            out.append(v % q)
    return out


def verify_ciphertexts(ct_path: str, sk_path: str, degree: int = 4096,
                       nprimes: int = 3,
                       values_path: str | None = None,
                       tol: float = 0.4) -> bool:
    """Decrypt+decode printed ciphertext dumps (adapter.cpp:32-169).

    ct_path: text file of 'name : { ... }' lines as produced by the
    reference's api tests / our io.serialize.format_poly, containing
    c0/c1 lines per prime per test (and optionally the cleartext values).

    Every prime participates: the per-prime components are decrypted and
    CRT-composed across the full chain (golden.ckks.decrypt_crt — the
    reference assembles the multi-prime SEAL ct and decrypts it,
    adapter/fileops.cpp:492-538), then decoded and compared to the
    cleartext within tol 0.4 (adapter.cpp:130-140; utils.h:212-243).
    Corruption of ANY prime's component fails the check (negative-tested
    in tests/test_api.py).
    """
    from .golden.ckks import decrypt_crt
    from .golden.encode import decode

    parms = default_parms(degree, nprimes)
    n = degree
    packed = serialize.read_sk(sk_path, n)

    with open(ct_path) as f:
        polys = serialize.parse_poly_stream(f)
    c0s = [np.array(v, dtype=np.uint32) for name, v in polys
           if name.strip().startswith("c0")]
    c1s = [np.array(v, dtype=np.uint32) for name, v in polys
           if name.strip().startswith("c1")]
    # Cleartext lines are named "v" / "v (cleartext)" (api_tests.c:73-75);
    # match the first token exactly so names merely containing the letter
    # v (e.g. "conj_vals") can never be misread as cleartext.
    values = [np.array(v, dtype=np.float64) for name, v in polys
              if re.match(r"\s*v\b", name)]
    if values_path:
        with open(values_path) as f:
            values = [np.array(v, dtype=np.float64)
                      for _, v in serialize.parse_poly_stream(f)]
    assert len(c0s) == len(c1s) and len(c0s) % nprimes == 0, \
        f"need c0/c1 per prime; got {len(c0s)}/{len(c1s)}"
    ntests = len(c0s) // nprimes

    ok_all = True
    for t in range(ntests):
        comps = [(c0s[t * nprimes + i].tolist(), c1s[t * nprimes + i].tolist())
                 for i in range(nprimes)]
        pte = decrypt_crt(parms, comps, packed)
        # Cross-prime consistency: a valid ct's composed plaintext is tiny
        # vs Q (message*scale + noise); a corrupted component shifts it by
        # ~Q/q_i.  int64 is the encode pipeline's own domain bound.
        if max(abs(x) for x in pte) >= 1 << 62:
            ok_all = False
            print(f"test {t}: FAIL (CRT-composed plaintext out of range — "
                  f"corrupted or inconsistent RNS component)")
            continue
        dec = np.asarray(decode(parms, np.array(pte, dtype=np.int64)))
        if t < len(values):
            want = values[t][: n // 2]
            err = float(np.abs(dec[: len(want)] - want).max())
            ok = err < tol
            ok_all &= ok
            print(f"test {t}: decode err {err:.4g} "
                  f"{'OK' if ok else 'FAIL'} ({nprimes} primes, CRT)")
        else:
            print(f"test {t}: decoded ({nprimes} primes, CRT; no cleartext "
                  f"to compare); first slots {dec[:4]}")
    return ok_all


def main(argv=None):
    p = argparse.ArgumentParser(prog="seal_embedded_jax.adapter")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="keygen + all precompute files")
    g.add_argument("--out", required=True)
    g.add_argument("--degree", type=int, default=4096)
    g.add_argument("--nprimes", type=int, default=3)
    g.add_argument("--sk-seed", default=None, help="hex, up to 64 bytes")
    g.add_argument("--pk-seed", default=None)

    v = sub.add_parser("verify", help="decrypt+decode printed ct dumps")
    v.add_argument("ct_file")
    v.add_argument("--sk", required=True)
    v.add_argument("--degree", type=int, default=4096)
    v.add_argument("--nprimes", type=int, default=3)
    v.add_argument("--values", default=None)

    sub.add_parser(
        "verify-seal",
        help="diff SEAL-stream serialization against a live Microsoft "
             "SEAL build (UNAVAILABLE offline — explicit TODO)")

    args = p.parse_args(argv)
    if args.cmd == "verify-seal":
        print(
            "verify-seal: NOT AVAILABLE in this environment.\n"
            "The io.sealstream writers are implemented field-for-field "
            "from the Microsoft SEAL 3.7.2 sources (serialization.h, "
            "ciphertext.cpp save/load members; see io/sealstream.py "
            "header) and round-trip structurally in "
            "tests/test_sealstream.py, but they have never been diffed "
            "against a LIVE SEAL binary: SEAL cannot be built offline "
            "(the reference adapter FetchContents it from GitHub; this "
            "environment has no egress).  When a vendored SEAL appears, "
            "wire it here: load the framework's .seal streams with "
            "SEALContext/Ciphertext::load and decrypt "
            "(adapter/adapter.cpp:32-169 is the recipe).")
        return 2
    if args.cmd == "generate":
        sk_seed = bytes.fromhex(args.sk_seed) if args.sk_seed else None
        pk_seed = bytes.fromhex(args.pk_seed) if args.pk_seed else None
        out = gen_save_all(args.out, args.degree, args.nprimes,
                           sk_seed, pk_seed)
        print(f"wrote keys + tables for n={args.degree}, "
              f"{args.nprimes} primes to {out['outdir']}")
        return 0
    ok = verify_ciphertexts(args.ct_file, args.sk, args.degree,
                            args.nprimes, args.values)
    print("VERIFY " + ("PASSED" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
