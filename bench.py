"""Benchmark: batched CKKS encode+encrypt throughput on a GPU.

Default mode ("all") emits component rows and the asym and deep-chain
pipelines as a sequence of JSON lines, and prints the headline line LAST
(sym n=4096/L=3, bit-exact encode, golden-verified) with the whole
matrix summarized in extra.matrix.

Pipeline rows carry the C-reference golden vectors in rows 0..G-1 of the
timed batch and re-check them bit for bit after timing (extra.verify).
Every line names the device (platform, device_kind, count) and the
card's name and power limit from nvidia-smi.  Timing ends each window in
block_until_ready.  It refuses to run without a GPU.

Config via env:
  BENCH_WHAT     all | pipeline | ntt | keccak | encode | sample |
                 index_map | verify | bsweep  (default all)
  BENCH_B        batch for single-config modes (default 1024)
  BENCH_ITERS    timed iterations (default 10)
  BENCH_DEGREE   polynomial degree (default 4096)
  BENCH_NPRIMES  RNS chain length (default 3)
  BENCH_PIPE     fused | limbwise | asym   (default fused)
  BENCH_ENCODE   f64 | sf | dd  (default: the platform's bit-exact mode,
                 api.ENCODE_BY_PLATFORM; dd is decode-exact only;
                 integer stages are bit-exact in every mode)
  BENCH_DD_TOO   1 (default) also measure encode=dd in extra; 0 skips
  BENCH_DEEP     1 (default) include n=8192/16384 deep chains in all;
                 0 limits "all" to the n=4096 rows + components
"""

import json
import os
import subprocess
import time

import numpy as np


def _device_info():
    """Identity of the device every line was measured on."""
    import jax
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()), "card": card.splitlines()[0]}


def _time(fn, args, iters, reps: int = 1):
    """Amortized timing: back-to-back dispatch, ending in
    block_until_ready.  With reps > 1 returns the MINIMUM per-rep
    average (short component rows vary with host contention)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        avg = (time.perf_counter() - t0) / iters
        best = avg if best is None else min(best, avg)
    return best, compile_s, out


def _emit(metric, value, unit, extra):
    line = {"metric": metric, "value": value, "unit": unit, "extra": extra}
    print(json.dumps(line), flush=True)
    return line


def _pipeline_inputs(parms, B, rng, encode_mode, pipe):
    """Batch inputs; rows 0..G-1 carry the C-reference golden vectors
    (same sk, same PRNG seeds) when they match the config, so the exact
    computation being timed is verified bit-for-bit."""
    import jax.numpy as jnp
    n = parms.degree
    gold = _load_golden(parms) if encode_mode != "dd" else None
    values_np = rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)
    share_np = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    err_np = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    if gold is not None and pipe in ("fused", "limbwise"):
        G = gold["G"]
        values_np[:G] = gold["v"]
        share_np[:G] = gold["share_words"]
        err_np[:G] = gold["err_words"]
        sk_np = gold["sk_signed"]
    else:
        gold = None
        sk_np = (rng.integers(0, 3, n) - 1).astype(np.int32)
    return (jnp.asarray(values_np), jnp.asarray(sk_np),
            jnp.asarray(share_np), jnp.asarray(err_np)), gold


def run_pipeline(parms, pipe, encode_mode, B, iters, rng, device,
                 dd_too=False):
    """One pipeline config -> result line dict (not yet printed)."""
    import jax.numpy as jnp
    degree, nprimes = parms.degree, parms.nprimes

    args, gold = _pipeline_inputs(parms, B, rng, encode_mode, pipe)

    if pipe == "fused":
        from seal_embedded_jax.ckks.fast import make_fused_encryptor
        fn = make_fused_encryptor(parms, encode_mode)
        metric = f"sym_encrypt_n{degree}_p{nprimes}_throughput"
    elif pipe == "limbwise":
        from seal_embedded_jax.ckks.limbwise import make_limbscan_encryptor
        fn = make_limbscan_encryptor(parms, "reference", encode_mode)
        metric = f"sym_encrypt_n{degree}_p{nprimes}_throughput"
    elif pipe == "asym":
        from seal_embedded_jax.ckks.asym import (gen_pk_batch,
                                                 make_fused_asym_encryptor)
        values, sk, share, err = args
        gold = _load_golden_asym(parms) if encode_mode != "dd" else None
        if gold is not None:
            # rows 0..G-1 carry the C-reference asym vectors: the golden
            # pk (adapter-format, NTT form), values and the deterministic
            # private seed, so the timed computation is verified
            # bit-for-bit on device like the sym rows.
            G = gold["G"]
            pk0 = jnp.asarray(gold["pk0"])
            pk1 = jnp.asarray(gold["pk1"])
            values = values.at[:G].set(jnp.asarray(gold["v"]))
            share = share.at[:G].set(jnp.asarray(gold["seed_words"]))
        else:
            ep = jnp.asarray(rng.integers(-20, 21, degree).astype(np.int32))
            pk0, pk1 = gen_pk_batch(
                sk, jnp.asarray(rng.integers(0, 2 ** 32, (1, 16))
                                .astype(np.uint32)), ep, parms)
        fn = make_fused_asym_encryptor(parms, encode_mode)
        args = (values, pk0, pk1, share)
        metric = f"asym_encrypt_n{degree}_p{nprimes}_throughput"
    else:
        raise SystemExit(f"unknown BENCH_PIPE {pipe!r}")

    avg_s, compile_s, out = _time(fn, args, iters)
    ok = bool(np.asarray(out["ok"]).all())
    assert ok, "sampler queue overflow or encode overflow"
    enc_per_s = B / avg_s

    extra = {
        "batch": B,
        "iters": iters,
        "avg_ms": avg_s * 1000,
        "compile_s": compile_s,
        "pipe": pipe,
        "encode": encode_mode,
        "device": device,
    }
    if gold is not None:
        extra["verify"] = _check_golden(out, gold, parms)

    if dd_too and pipe == "fused" and encode_mode != "dd":
        from seal_embedded_jax.ckks.fast import make_fused_encryptor
        fn_dd = make_fused_encryptor(parms, "dd")
        avg_dd, compile_dd, out_dd = _time(fn_dd, args, iters)
        assert bool(np.asarray(out_dd["ok"]).all())
        extra["dd_enc_per_s"] = B / avg_dd
        extra["dd_avg_ms"] = avg_dd * 1000
        extra["dd_compile_s"] = compile_dd

    return {"metric": metric, "value": enc_per_s, "unit": "enc/s",
            "extra": extra}


def main():
    import jax
    import seal_embedded_jax  # noqa: F401  (x64 + compile cache)
    from seal_embedded_jax.api import ENCODE_BY_PLATFORM
    from seal_embedded_jax.config import default_parms

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{jax.devices()[0]}")
    B = int(os.environ.get("BENCH_B", "1024"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    degree = int(os.environ.get("BENCH_DEGREE", "4096"))
    nprimes = int(os.environ.get("BENCH_NPRIMES", "3"))
    pipe = os.environ.get("BENCH_PIPE", "fused")
    encode_mode = os.environ.get("BENCH_ENCODE",
                                 ENCODE_BY_PLATFORM[jax.default_backend()])
    what = os.environ.get("BENCH_WHAT", "all")

    rng = np.random.default_rng(0)
    device = _device_info()

    if what == "all":
        _all(B, iters, rng, device, encode_mode)
        return
    parms = default_parms(degree, nprimes)
    if what == "bsweep":
        # The bit-exact pipeline at B = 1024 / 2048 / 4096 / 8192 with the
        # per-B device-memory high-water mark.
        for Bs in (1024, 2048, 4096, 8192):
            line = run_pipeline(parms, "fused", encode_mode, Bs,
                                max(3, iters // 2), rng, device)
            stats = jax.local_devices()[0].memory_stats()
            line["extra"]["peak_bytes_in_use"] = stats["peak_bytes_in_use"]
            print(json.dumps(line), flush=True)
        return
    if what == "verify":
        _verify_only(parms, device, encode_mode)
    elif what == "pipeline":
        line = run_pipeline(parms, pipe, encode_mode, B, iters, rng, device,
                            dd_too=os.environ.get("BENCH_DD_TOO", "1") == "1")
        print(json.dumps(line), flush=True)
    else:
        _component(what, parms, B, iters, rng, device, encode_mode)


def _all(B, iters, rng, device, encode_mode):
    """Component rows, asym + deep-chain pipelines, headline LAST."""
    from seal_embedded_jax.config import default_parms

    deep = os.environ.get("BENCH_DEEP", "1") == "1"
    p4096 = default_parms(4096, 3)
    matrix = {}

    for what in ("ntt", "keccak", "encode", "sample", "index_map"):
        line = _component(what, p4096, B, iters, rng, device, encode_mode)
        matrix[line["metric"]] = line["value"]

    asym = run_pipeline(p4096, "asym", encode_mode, B, iters, rng, device)
    _emit(**asym)
    matrix[asym["metric"]] = asym["value"]

    if deep:
        for pipe, n, L, Bd in (("fused", 8192, 6, 1024),
                               ("fused", 16384, 13, 1024),
                               ("asym", 8192, 6, 1024),
                               ("asym", 16384, 13, 512)):
            line = run_pipeline(default_parms(n, L), pipe, encode_mode, Bd,
                                max(3, iters // 2), rng, device,
                                dd_too=False)
            _emit(**line)
            matrix[line["metric"]] = line["value"]

    head = run_pipeline(p4096, "fused", encode_mode, B, iters, rng, device,
                        dd_too=True)
    head["extra"]["matrix"] = matrix
    _emit(**head)


def _load_golden(parms):
    """Flagship golden vectors (captured from the C reference binary) when
    they match the benched config; None otherwise."""
    import pathlib
    path = (pathlib.Path(__file__).parent / "tests" /
            f"golden_sym_{parms.degree}_{parms.nprimes}.npz")
    if not path.exists():
        return None
    from seal_embedded_jax.ops import keccak as kc
    data = np.load(path)
    G = sum(1 for k in data.files if k.startswith("v_"))
    n = parms.degree
    sk_packed = bytes(data["sk_packed_0"].tolist())
    sk_signed = np.array(
        [((sk_packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1 for i in range(n)],
        dtype=np.int32)

    def seed_bytes(tag):
        return bytes((tag + i) & 0xFF for i in range(64))

    L = parms.nprimes
    return {
        "G": G,
        "v": np.stack([data[f"v_{t}"] for t in range(G)]),
        "share_words": np.tile(kc.seed_to_words(seed_bytes(2)), (G, 1)),
        "err_words": np.tile(kc.seed_to_words(seed_bytes(3)), (G, 1)),
        "sk_signed": sk_signed,
        "c0": [[data[f"c0_{L * t + i}"] for i in range(L)] for t in range(G)],
        "c1": [[data[f"c1_{L * t + i}"] for i in range(L)] for t in range(G)],
    }


def _load_golden_asym(parms):
    """Asymmetric golden vectors (tests/golden_asym_*.npz) when they match
    the benched config; None otherwise."""
    import pathlib
    path = (pathlib.Path(__file__).parent / "tests" /
            f"golden_asym_{parms.degree}_{parms.nprimes}.npz")
    if not path.exists():
        return None
    from seal_embedded_jax.ops import keccak as kc
    data = np.load(path)
    G = sum(1 for k in data.files if k.startswith("v_"))
    L = parms.nprimes

    def seed_bytes(tag):
        return bytes((tag + i) & 0xFF for i in range(64))

    return {
        "G": G,
        "v": np.stack([data[f"v_{t}"] for t in range(G)]),
        "seed_words": np.tile(kc.seed_to_words(seed_bytes(3)), (G, 1)),
        "pk0": np.stack([data[f"pk0_{i}"] for i in range(L)]),
        "pk1": np.stack([data[f"pk1_{i}"] for i in range(L)]),
        "c0": [[data[f"c0_{L * t + i}"] for i in range(L)] for t in range(G)],
        "c1": [[data[f"c1_{L * t + i}"] for i in range(L)] for t in range(G)],
    }


def _check_golden(out, gold, parms):
    """Bit-compare rows 0..G-1 of a timed batch against the C-reference
    golden ciphertexts.  Raises on mismatch; returns a marker string."""
    c0 = np.asarray(out["c0"])
    c1 = np.asarray(out["c1"])
    for t in range(gold["G"]):
        for i in range(parms.nprimes):
            assert np.array_equal(c0[i, t], gold["c0"][t][i]), \
                f"golden c0 mismatch test {t} prime {i}"
            assert np.array_equal(c1[i, t], gold["c1"][t][i]), \
                f"golden c1 mismatch test {t} prime {i}"
    return f"golden-bitexact-ok({gold['G']}x{parms.nprimes})"


def _verify_only(parms, device, encode_mode):
    """BENCH_WHAT=verify: re-check the golden vectors on this backend with
    the fused pipeline and emit a one-line result."""
    import jax.numpy as jnp
    gold = _load_golden(parms)
    if gold is None:
        raise SystemExit(f"no golden vectors for n={parms.degree} "
                         f"L={parms.nprimes}")
    from seal_embedded_jax.ckks.fast import make_fused_encryptor
    fn = make_fused_encryptor(parms, encode_mode)
    out = fn(jnp.asarray(gold["v"]), jnp.asarray(gold["sk_signed"]),
             jnp.asarray(gold["share_words"]), jnp.asarray(gold["err_words"]))
    marker = _check_golden(out, gold, parms)
    _emit(f"golden_verify_n{parms.degree}_p{parms.nprimes}", 1.0, "bitexact",
          {"verify": marker, "encode": encode_mode, "device": device})


def _component(what, parms, B, iters, rng, device, encode_mode):
    """Component benchmarks, mirroring the reference's bench suite
    (device/bench/bench_{ntt,sample,ifft,index_map}.c).  Each times the
    function the pipelines dispatch to on this backend."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    n = parms.degree
    L = parms.nprimes
    moduli = tuple(int(q) for q in parms.moduli)

    if what == "ntt":
        # The pipelines' all-limb NTT over (L, B, n).
        from seal_embedded_jax.ckks.fast import _ntt_all_limbs
        x = jnp.asarray(np.stack(
            [rng.integers(0, q, (B, n)).astype(np.uint32) for q in moduli]))
        fn = jax.jit(partial(_ntt_all_limbs, moduli=moduli))
        avg_s, compile_s, _ = _time(fn, (x,), iters, reps=3)
        logn = n.bit_length() - 1
        bflys = L * B * (n // 2) * logn / avg_s
        return _emit(f"ntt_n{n}_butterflies_per_s", bflys / 1e9, "Gbfly/s",
                     {"avg_ms": avg_s * 1000, "L": L, "B": B,
                      "compile_s": compile_s, "device": device})
    if what == "keccak":
        # The uniform sampler's base squeeze: one stream per message.
        from seal_embedded_jax.ops.keccak import default_impl, shake256_words
        share = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16))
                            .astype(np.uint32))
        ctr = jnp.zeros((B, 2), jnp.uint32)
        nblocks = -(-4 * n // 136)
        fn = jax.jit(partial(shake256_words, nblocks=nblocks))
        avg_s, compile_s, _ = _time(fn, (share, ctr), iters, reps=3)
        perms = B * nblocks / avg_s
        return _emit("keccakf1600_perms_per_s", perms / 1e6, "Mperm/s",
                     {"avg_ms": avg_s * 1000, "B": B, "nblocks": nblocks,
                      "impl": default_impl(), "compile_s": compile_s,
                      "device": device})
    if what == "encode":
        from seal_embedded_jax.ops.encode import encode_any
        values = jnp.asarray(rng.uniform(-1, 1, (B, n // 2))
                             .astype(np.float32))
        fn = jax.jit(partial(encode_any, parms=parms, mode=encode_mode))
        avg_s, compile_s, _ = _time(fn, (values,), iters, reps=3)
        extra = {"avg_ms": avg_s * 1000, "B": B, "compile_s": compile_s,
                 "device": device}
        if encode_mode != "dd":
            fn_dd = jax.jit(partial(encode_any, parms=parms, mode="dd"))
            avg_dd, _, _ = _time(fn_dd, (values,), iters)
            extra["dd_encode_per_s"] = B / avg_dd
        return _emit(f"encode_{encode_mode}_n{n}_per_s", B / avg_s,
                     "encode/s", extra)
    if what == "sample":
        from seal_embedded_jax.ops import sampling as sp
        share = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16))
                            .astype(np.uint32))
        ctr = jnp.zeros((B, 2), jnp.uint32)
        fn = jax.jit(partial(sp.sample_uniform, n=n, q=moduli[0],
                             queue_cap=sp.queue_cap_for(n, moduli)))
        avg_s, compile_s, _ = _time(fn, (share, ctr), iters, reps=3)
        return _emit(
            f"sample_uniform_n{n}_per_s", B / avg_s, "poly/s",
            {"avg_ms": avg_s * 1000, "B": B, "compile_s": compile_s,
             "device": device})
    if what == "index_map":
        # bench_index_map.c analog: time the index-map computation itself
        # (gen-3 orbit merged with bitrev, ckks_common.c:32-68).  Host-side
        # by design — the map is a trace-time constant folded into the
        # placement gather, computed once per degree and cached.
        from seal_embedded_jax.golden.encode import calc_index_map
        logn = n.bit_length() - 1
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            imap = calc_index_map(n, logn)
        avg_s = (time.perf_counter() - t0) / reps
        assert imap.shape == (n,)
        return _emit(
            f"index_map_n{n}_per_s", 1.0 / avg_s, "maps/s",
            {"avg_ms": avg_s * 1000, "where": "host", "device": device})
    raise SystemExit(f"unknown BENCH_WHAT {what!r}")


if __name__ == "__main__":
    main()
