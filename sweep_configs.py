"""Config-matrix sweep — the reference's test_all_configs.sh analog.

The reference sweeps its compile-time option matrix (data_load x ifft x
ntt x index_map x sk = 160 rebuilds, device/scripts/test_all_configs.sh);
this framework's option space is runtime, so one process sweeps it:

    pipeline x encode x layout x order

For every config the full batched encode+encrypt runs and is checked:

* ok-flags must all be set;
* configs that are specified to be BIT-IDENTICAL to the baseline
  (limbwise / reference-layout / forward / f64-encode) are compared
  ciphertext-bit-for-bit: fused==limbwise, stream==scan, sf==f64 (on
  backends whose f64 encode is bit-exact, api.ENCODE_BY_PLATFORM; sf is
  the cross-backend bit-exact mode);
* every config (including dd-encode, parallel layout, reverse walk —
  different bytes by design) must decrypt+decode back to the cleartext
  within the reference's decode tolerance (ckks_tests_common.c:228).

Usage:  python sweep_configs.py [--degree 512] [--batch 4] [--quick]
Exit status 0 iff every config passes; prints one summary line per
config.  tests/test_sweep.py runs the trimmed (--quick) matrix in CI.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np


def run_sweep(degree: int = 512, batch: int = 4, quick: bool = False):
    import jax
    import jax.numpy as jnp
    import seal_embedded_jax  # noqa: F401
    from seal_embedded_jax.api import ENCODE_BY_PLATFORM
    from seal_embedded_jax.config import Parms, PRIMES_27BIT, default_parms
    from seal_embedded_jax.ckks.fast import sym_encrypt_fused
    from seal_embedded_jax.ckks.limbwise import sym_encrypt_limbscan
    from seal_embedded_jax.ckks.stream import sym_encrypt_stream
    from seal_embedded_jax.ckks.sym import make_decryptor
    from seal_embedded_jax.ops.encode import make_decoder
    from functools import partial

    if degree <= 2048:
        parms = Parms(degree=degree, moduli=PRIMES_27BIT[:3],
                      scale=2.0 ** 20)
    else:
        parms = default_parms(degree, 3)
    n = parms.degree
    rng = np.random.default_rng(0)
    values = jnp.asarray(rng.uniform(-1, 1, (batch, n // 2))
                         .astype(np.float32))
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    share = jnp.asarray(rng.integers(0, 2 ** 32, (batch, 16))
                        .astype(np.uint32))
    err = jnp.asarray(rng.integers(0, 2 ** 32, (batch, 16))
                      .astype(np.uint32))

    ieee_backend = ENCODE_BY_PLATFORM.get(jax.default_backend()) == "f64"
    decryptor = make_decryptor(parms)
    decoder = make_decoder(parms)

    def decode_check(c0, c1):
        centered = decryptor(jnp.asarray(c0), jnp.asarray(c1), sk)
        worst = 0.0
        for i in range(parms.nprimes):
            dec = np.asarray(decoder(centered[i]))
            worst = max(worst, float(np.abs(dec - np.asarray(values)).max()))
        return worst

    encodes = ["f64", "sf"] if quick else ["f64", "dd", "sf"]
    results = []

    def record(name, out_c0, out_c1, ok, bitexact_vs_base):
        worst = decode_check(out_c0, out_c1)
        passed = bool(ok) and worst < 0.1
        match = None
        if bitexact_vs_base and base_ct is not None:
            match = (np.array_equal(out_c0, base_ct[0])
                     and np.array_equal(out_c1, base_ct[1]))
            passed = passed and match
        results.append((name, passed, worst, match))
        print(f"{'PASS' if passed else 'FAIL'}  {name:<58} "
              f"max|dec-v|={worst:.2e}"
              + (f"  bit=={match}" if match is not None else ""))
        return passed

    # Baseline: limbwise / reference / forward / f64.
    base = jax.jit(partial(sym_encrypt_limbscan, parms=parms,
                           layout="reference", encode_mode="f64",
                           order="forward"))(values, sk, share, err)
    base_ct = (np.asarray(base["c0"]), np.asarray(base["c1"]))
    record("limbwise layout=reference order=forward encode=f64 [baseline]",
           base_ct[0], base_ct[1], bool(np.asarray(base["ok"]).all()), False)

    # limbwise matrix: layout x order x encode.
    for layout, order, enc in itertools.product(
            ["reference", "parallel"], ["forward", "reverse"], encodes):
        if (layout, order, enc) == ("reference", "forward", "f64"):
            continue
        if quick and (layout, order) not in (("reference", "forward"),
                                             ("parallel", "forward"),
                                             ("reference", "reverse")):
            continue
        out = jax.jit(partial(sym_encrypt_limbscan, parms=parms,
                              layout=layout, encode_mode=enc,
                              order=order))(values, sk, share, err)
        c0, c1 = np.asarray(out["c0"]), np.asarray(out["c1"])
        if order == "reverse":  # limbs come out in reverse chain order
            c0, c1 = c0[::-1], c1[::-1]
        # Spec: bit-equal to baseline iff same stream layout+walk and the
        # encode is IEEE-bit-exact on this backend.
        bitexact = (layout == "reference" and order == "forward"
                    and (enc == "sf" or (enc == "f64" and ieee_backend)))
        record(f"limbwise layout={layout} order={order} encode={enc}",
               c0, c1, bool(np.asarray(out["ok"]).all()), bitexact)

    # fused pipeline: encode.
    for enc in encodes:
        out = jax.jit(partial(sym_encrypt_fused, parms=parms,
                              encode_mode=enc))(values, sk, share, err)
        bitexact = (enc == "sf" or (enc == "f64" and ieee_backend))
        record(f"fused encode={enc}",
               np.asarray(out["c0"]), np.asarray(out["c1"]),
               bool(np.asarray(out["ok"]).all()), bitexact)

    # streaming pipeline: order x encode (f64 only in quick mode).
    for order, enc in itertools.product(
            ["forward", "reverse"], encodes[:1] if quick else encodes):
        outs = list(sym_encrypt_stream(values, sk, share, err, parms,
                                       encode_mode=enc, order=order))
        outs.sort(key=lambda d: d["prime_idx"])
        c0 = np.stack([d["c0"] for d in outs])
        c1 = np.stack([d["c1"] for d in outs])
        ok = all(d["ok"] for d in outs)
        bitexact = (order == "forward"
                    and (enc == "sf" or (enc == "f64" and ieee_backend)))
        record(f"stream order={order} encode={enc}", c0, c1, ok, bitexact)

    # OTF-roots NTT (SE_NTT_TYPE 0/1 analog, ntt.c:40-52,144-149): roots
    # synthesized in-graph, non-lazy Barrett butterflies — ciphertexts
    # must be bit-identical to table mode (same values mod q, canonical).
    from seal_embedded_jax.ckks.sym import sym_encrypt_batch
    out = jax.jit(partial(sym_encrypt_batch, parms=parms,
                          ntt_variant="otf"))(values, sk, share, err)
    bitexact = ieee_backend  # encode=f64 inside sym_encrypt_batch
    record("batch ntt=otf encode=f64", np.asarray(out["c0"]),
           np.asarray(out["c1"]), bool(np.asarray(out["ok"]).all()),
           bitexact)

    # Loaded-table data path (SE_INDEX_MAP_LOAD + SE_IFFT_LOAD_FULL,
    # fileops.c:208-255): write the adapter-format index map and ifft
    # root files, read them back, and run the pipeline CONSUMING them.
    import tempfile
    from seal_embedded_jax.io import serialize
    from seal_embedded_jax.ops.encode import (ifft_root_tables_from_file,
                                              index_map_np)
    with tempfile.TemporaryDirectory() as d:
        imap_path = os.path.join(d, f"index_map_{n}.dat")
        roots_path = os.path.join(d, f"ifft_roots_{n}.dat")
        serialize.write_index_map(imap_path, index_map_np(n))
        serialize.write_ifft_roots(roots_path, n, n.bit_length() - 1)
        imap = serialize.read_index_map(imap_path, n).astype(np.int32)
        tables = ifft_root_tables_from_file(roots_path, n)
    out = jax.jit(partial(sym_encrypt_batch, parms=parms,
                          root_tables=tables, imap=imap))(
        values, sk, share, err)
    record("batch data=loaded(index_map,ifft_roots) encode=f64",
           np.asarray(out["c0"]), np.asarray(out["c1"]),
           bool(np.asarray(out["ok"]).all()), ieee_backend)

    # Asymmetric: batch pipeline vs per-prime streaming must agree limb
    # by limb, and decrypt+decode within tolerance (ckks_asym.c:205-288).
    from seal_embedded_jax.ckks.asym import gen_pk_batch, make_asym_encryptor
    from seal_embedded_jax.ckks.stream import asym_encrypt_stream
    ep = jnp.asarray(rng.integers(-20, 21, n).astype(np.int32))
    pk0, pk1 = gen_pk_batch(
        sk, jnp.asarray(rng.integers(0, 2 ** 32, (1, 16)).astype(np.uint32)),
        ep, parms)
    aout = make_asym_encryptor(parms)(values, pk0, pk1, err)
    limbs = sorted(asym_encrypt_stream(values, pk0, pk1, err, parms),
                   key=lambda d: d["prime_idx"])
    same = (np.array_equal(np.stack([d["c0"] for d in limbs]),
                           np.asarray(aout["c0"]))
            and np.array_equal(np.stack([d["c1"] for d in limbs]),
                               np.asarray(aout["c1"])))
    worst = decode_check(np.asarray(aout["c0"]), np.asarray(aout["c1"]))
    passed = bool(np.asarray(aout["ok"]).all()) and worst < 0.1 and same
    results.append(("asym batch==stream", passed, worst, same))
    print(f"{'PASS' if passed else 'FAIL'}  {'asym batch==stream':<58} "
          f"max|dec-v|={worst:.2e}  bit=={same}")

    # Loaded fast-INTT decrypt oracle (SE_INTT_FAST, intt.c:72-129):
    # re-check the baseline ciphertexts with the lazy INTT consuming
    # intt_fast_roots_*.dat — must be value-identical to the canonical
    # decrypt used by decode_check above.
    from seal_embedded_jax.ckks.sym import decrypt_batch
    with tempfile.TemporaryDirectory() as d:
        serialize.write_intt_roots(d, parms, fast=True)
        loaded = {}
        for q in parms.moduli:
            q = int(q)
            pairs = serialize.read_ntt_roots(
                os.path.join(d, f"intt_fast_roots_{n}_{q}.dat"), n, fast=True)
            loaded[q] = (pairs[:, 0].copy(), pairs[:, 1].copy())
    want = np.asarray(decrypt_batch(jnp.asarray(base_ct[0]),
                                    jnp.asarray(base_ct[1]), sk, parms))
    got = np.asarray(decrypt_batch(jnp.asarray(base_ct[0]),
                                   jnp.asarray(base_ct[1]), sk, parms,
                                   intt_impl="lazy", loaded_intt=loaded))
    passed = np.array_equal(got, want)
    results.append(("decrypt intt=lazy(loaded fast tables)", passed, 0.0,
                    passed))
    print(f"{'PASS' if passed else 'FAIL'}  "
          f"{'decrypt intt=lazy(loaded fast tables)':<58} bit=={passed}")

    failed = [name for name, passed, _, _ in results if not passed]
    print(f"\n{len(results) - len(failed)}/{len(results)} configs passed"
          + (f"; FAILED: {failed}" if failed else ""))
    return not failed


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--degree", type=int, default=512)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--quick", action="store_true")
    args = p.parse_args(argv)
    return 0 if run_sweep(args.degree, args.batch, args.quick) else 1


if __name__ == "__main__":
    sys.exit(main())
