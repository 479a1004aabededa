"""Public API surface: streaming callbacks, seed-expandable cts, reverse
chain walk, config banner."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax import api
from seal_embedded_jax.config import Parms, PRIMES_27BIT
from seal_embedded_jax.io import network, serialize

from conftest import seed_bytes

P1K = Parms(degree=1024, moduli=PRIMES_27BIT[:1], scale=2.0 ** 20)


def _ctx():
    ctx = api.se_setup_custom(1024, 1, 2.0 ** 20, api.SYM,
                              sk_seed=seed_bytes(1))
    return ctx


def test_send_callback_streaming_order():
    ctx = _ctx()
    vals = np.linspace(-1, 1, 512, dtype=np.float32)[None, :]
    send, store = network.collecting_sender()
    out = api.se_encrypt_seeded(ctx, vals, share_seeds=[seed_bytes(2)],
                                seeds=[seed_bytes(3)], send=send)
    # c0 then c1 per prime per message (seal_embedded.c:180-204)
    assert len(store) == 2 * ctx.parms.nprimes
    c0 = np.asarray(out["c0"])
    assert np.array_equal(serialize.ct_component_from_bytes(store[0]),
                          c0[0, 0])


def test_seeded_ct_roundtrip():
    from seal_embedded_jax.ckks.limbwise import make_c1_expander
    from seal_embedded_jax.ckks.sym import make_decryptor

    ctx = _ctx()
    vals = np.linspace(-1, 1, 512, dtype=np.float32)[None, :]
    send, store = network.collecting_sender()
    out = api.se_encrypt_seeded(ctx, vals, share_seeds=[seed_bytes(2)],
                                seeds=[seed_bytes(3)], send=send,
                                send_seed_only=True)
    assert len(store) == 1  # one compressed blob per message
    seed, c0 = serialize.seeded_ct_parse(store[0])
    assert seed == seed_bytes(2)

    # Receiver side: expand c1 from the seed, then decrypt.
    from seal_embedded_jax.ops.keccak import seed_to_words
    sw = jnp.asarray(seed_to_words(seed)[None, :])
    c1, ok = make_c1_expander(ctx.parms)(sw)
    assert bool(np.asarray(ok).all())
    assert np.array_equal(np.asarray(c1), np.asarray(out["c1"]))
    cen = make_decryptor(ctx.parms)(
        jnp.asarray(c0[:, None, :]), c1, jnp.asarray(ctx.sk_signed))
    assert np.array_equal(np.asarray(cen)[0, 0], np.asarray(out["pte"])[0])


def test_reverse_chain_walk():
    from seal_embedded_jax.ckks.limbwise import make_limbscan_encryptor

    parms = Parms(degree=64, moduli=PRIMES_27BIT[:3], scale=2.0 ** 20)
    rng = np.random.default_rng(0)
    B, n = 2, parms.degree
    values = jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32))
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    share = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))
    err = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))

    fwd = make_limbscan_encryptor(parms, "reference", "f64", "forward")(
        values, sk, share, err)
    rev = make_limbscan_encryptor(parms, "reference", "f64", "reverse")(
        values, sk, share, err)
    assert bool(np.asarray(rev["ok"]).all())
    # Reverse walk draws prime L-1 first: its c1 equals the forward walk's
    # prime-0 c1 only when the uniform draw consumed identical counters --
    # generally different streams, but each (c0, c1) must still decrypt.
    from seal_embedded_jax.ckks.sym import make_decryptor
    parms_rev = Parms(degree=64, moduli=tuple(reversed(parms.moduli)),
                      scale=parms.scale)
    cen = np.asarray(make_decryptor(parms_rev)(rev["c0"], rev["c1"], sk))
    assert np.array_equal(cen[0], np.asarray(rev["pte"]))
    assert np.array_equal(
        np.asarray(fwd["pte"]), np.asarray(rev["pte"]))


def test_print_config(capsys):
    ctx = _ctx()
    banner = api.print_config(ctx)
    assert "degree" in banner and "1024" in banner


def test_api_to_adapter_verify(tmp_path):
    """End-to-end cross-check mirroring the reference's api_tests ->
    adapter verify_ciphertexts flow (adapter.cpp:29-169): encrypt via the
    public API, dump cts in the printed-poly text format, then decrypt/
    decode them with the adapter and compare to the cleartext."""
    from seal_embedded_jax import adapter
    from seal_embedded_jax.golden.sampling import (
        sample_small_poly_ternary_96)
    from seal_embedded_jax.golden.prng import Prng

    ctx = _ctx()
    n = ctx.parms.degree
    # sk file in the reference's 2-bit packed format
    packed = sample_small_poly_ternary_96(n, Prng(seed_bytes(1)))
    sk_path = tmp_path / f"sk_{n}.dat"
    serialize.write_sk(str(sk_path), packed)

    rng = np.random.default_rng(7)
    vals = rng.uniform(-1, 1, (3, n // 2)).astype(np.float32)
    out = api.se_encrypt_seeded(
        ctx, vals, share_seeds=[seed_bytes(10 + i) for i in range(3)],
        seeds=[seed_bytes(20 + i) for i in range(3)])
    assert bool(np.asarray(out["ok"]).all())

    ct_path = tmp_path / "out_sym_api_tests"
    with open(ct_path, "w") as f:
        for b in range(3):
            f.write(serialize.format_poly(
                "v", np.asarray(vals[b], dtype=np.float64)))
            for i in range(ctx.parms.nprimes):
                f.write(serialize.format_poly(
                    f"c0 (t{b} p{i})", np.asarray(out["c0"])[i, b]))
                f.write(serialize.format_poly(
                    f"c1 (t{b} p{i})", np.asarray(out["c1"])[i, b]))

    assert adapter.verify_ciphertexts(
        str(ct_path), str(sk_path), degree=n, nprimes=ctx.parms.nprimes)


def test_adapter_verify_multiprime_and_corruption(tmp_path):
    """adapter verify decrypts EVERY prime (CRT-composed): corrupting any
    single prime's component must fail the check (the
    adapter.cpp:130-140 oracle strength)."""
    from seal_embedded_jax import adapter
    from seal_embedded_jax.golden.prng import Prng
    from seal_embedded_jax.golden.sampling import (
        sample_small_poly_ternary_96)

    ctx = api.se_setup_default(api.SYM, sk_seed=seed_bytes(1))
    n, L = 4096, 3
    packed = sample_small_poly_ternary_96(n, Prng(seed_bytes(1)))
    sk_path = tmp_path / f"sk_{n}.dat"
    serialize.write_sk(str(sk_path), packed)

    rng = np.random.default_rng(9)
    vals = rng.uniform(-1, 1, (2, n // 2)).astype(np.float32)
    out = api.se_encrypt_seeded(
        ctx, vals, share_seeds=[seed_bytes(30 + i) for i in range(2)],
        seeds=[seed_bytes(40 + i) for i in range(2)])
    assert bool(np.asarray(out["ok"]).all())

    def dump(path, corrupt_prime=None):
        c0 = np.asarray(out["c0"]).copy()
        if corrupt_prime is not None:
            c0[corrupt_prime, 0, 5] ^= 1  # flip one coefficient bit
        with open(path, "w") as f:
            for b in range(2):
                f.write(serialize.format_poly(
                    "v", np.asarray(vals[b], dtype=np.float64)))
                for i in range(L):
                    f.write(serialize.format_poly(f"c0 (t{b} p{i})",
                                                  c0[i, b]))
                    f.write(serialize.format_poly(
                        f"c1 (t{b} p{i})", np.asarray(out["c1"])[i, b]))

    good = tmp_path / "cts_good"
    dump(good)
    assert adapter.verify_ciphertexts(str(good), str(sk_path),
                                      degree=n, nprimes=L)
    # Corrupting the LAST prime (the one the old single-prime verify never
    # looked at) must now fail.
    for p in (2, 1):
        bad = tmp_path / f"cts_bad_{p}"
        dump(bad, corrupt_prime=p)
        assert not adapter.verify_ciphertexts(str(bad), str(sk_path),
                                              degree=n, nprimes=L), p


def test_adapter_verify_cleartext_name_anchoring(tmp_path):
    """Only lines whose first token is exactly 'v' count as cleartext
    (api_tests.c:73-75 names them "v (cleartext)"): a line named
    "conj_vals" — which CONTAINS the letter v — must not be misread as
    cleartext (ADVICE r3 sharp edge)."""
    from seal_embedded_jax import adapter
    from seal_embedded_jax.golden.prng import Prng
    from seal_embedded_jax.golden.sampling import (
        sample_small_poly_ternary_96)

    ctx = _ctx()
    n = ctx.parms.degree
    packed = sample_small_poly_ternary_96(n, Prng(seed_bytes(1)))
    sk_path = tmp_path / f"sk_{n}.dat"
    serialize.write_sk(str(sk_path), packed)

    rng = np.random.default_rng(11)
    vals = rng.uniform(-1, 1, (1, n // 2)).astype(np.float32)
    out = api.se_encrypt_seeded(
        ctx, vals, share_seeds=[seed_bytes(50)], seeds=[seed_bytes(51)])
    assert bool(np.asarray(out["ok"]).all())

    ct_path = tmp_path / "dump"
    with open(ct_path, "w") as f:
        # decoy: name contains 'v' but is NOT a cleartext line; its values
        # would decode to garbage if misclassified
        f.write(serialize.format_poly(
            "conj_vals (debug)", np.arange(n, dtype=np.uint32)))
        f.write(serialize.format_poly(
            "v (cleartext)", np.asarray(vals[0], dtype=np.float64)))
        for i in range(ctx.parms.nprimes):
            f.write(serialize.format_poly(
                "c0 (t0)", np.asarray(out["c0"])[i, 0]))
            f.write(serialize.format_poly(
                "c1 (t0)", np.asarray(out["c1"])[i, 0]))
    assert adapter.verify_ciphertexts(
        str(ct_path), str(sk_path), degree=n, nprimes=ctx.parms.nprimes)


def test_asym_setup_with_given_pk_golden():
    """se_setup_custom(pk=(pk0, pk1)) + se_encrypt_seeded reproduce the
    C-reference asym ciphertexts (n=4096, 3 primes)."""
    import pathlib
    data = np.load(pathlib.Path(__file__).parent / "golden_asym_4096_3.npz")
    L, rows = 3, 2
    pk = (np.stack([data[f"pk0_{i}"] for i in range(L)]),
          np.stack([data[f"pk1_{i}"] for i in range(L)]))
    ctx = api.se_setup_custom(4096, L, 2.0 ** 25, api.ASYM, pk=pk)
    assert ctx.resolved_encode_mode() == "f64"
    vals = np.stack([data[f"v_{t}"] for t in range(rows)])
    out = api.se_encrypt_seeded(ctx, vals, seeds=[seed_bytes(3)] * rows)
    assert bool(np.asarray(out["ok"]).all())
    for t in range(rows):
        for i in range(L):
            assert np.array_equal(np.asarray(out["c0"])[i, t],
                                  data[f"c0_{L * t + i}"])
            assert np.array_equal(np.asarray(out["c1"])[i, t],
                                  data[f"c1_{L * t + i}"])
