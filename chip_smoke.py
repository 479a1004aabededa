"""Smoke test of the encrypt path on NVIDIA GPUs, bit-exact against the
C-reference golden vectors.

    python chip_smoke.py               # one card: phases a-e below
    python chip_smoke.py --four-cards  # batch-sharded sym 16384/13 on four

Phases on one card:
  a. device check: stops unless JAX's first device is a GPU; prints the
     card's name and power limit;
  b. the SHAKE-256 squeeze kernel, compiled at the widths the widest
     pipeline calls it with, bit-compared with the jnp Keccak and hashlib;
  c. golden pipelines through api.se_setup_custom / se_encrypt_seeded:
     sym 4096/3, sym 16384/13 and asym 16384/13 at B=1024, a few batches
     each, golden rows checked bit for bit in every batch;
  d. encode bits: native f64 and software f64 ('sf') against every golden
     plaintext, and the double-double mode's decode error;
  e. wire format: one small batch through `send` and one through
     `send_seed_only`, with c1 expanded back from the seeds.

Any failure raises, so the exit code is non-zero and no result line is
printed.  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
B = 1024
ITERS = 3


def log(*a):
    print(*a, flush=True)


def seed_bytes(tag: int) -> bytes:
    """Deterministic seeds of the golden driver (golden/golden_driver.c)."""
    return bytes((tag + i) & 0xFF for i in range(64))


def device_check():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {dev}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(card)  # as nvidia-smi prints it: name, power limit
    log(f"[a] jax {jax.__version__}: platform={dev.platform} "
        f"kind={dev.device_kind} count={len(jax.devices())}")
    return dev


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


# ----------------------------------------------------------------- phase b

def kernel_check():
    import jax
    import jax.numpy as jnp
    from seal_embedded_jax.config import default_parms
    from seal_embedded_jax.ops import keccak as kc
    from seal_embedded_jax.ops import sampling as sp

    parms = default_parms(16384, 13)
    n = parms.degree
    cap = sp.queue_cap_for(n, parms.moduli)
    rng = np.random.default_rng(0)
    seeds = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16), dtype=np.uint32))
    zero = sp.counter_zero((B,))
    nfills = -(-n // 16)
    calls = [
        ("uniform base", zero, sp._blocks_for_bytes(4 * n), None),
        ("uniform queue", sp._c_offsets(zero, 1 + jnp.arange(
            cap, dtype=jnp.uint32)), 1, 1),
        ("cbd", sp._c_offsets(zero, jnp.arange(nfills, dtype=jnp.uint32)),
         1, 24),
    ]
    for name, ctr, nblocks, nwords in calls:
        def squeeze(impl):
            return jax.jit(lambda s, c: kc.shake256_words(
                s, c, nblocks, impl=impl, nwords=nwords))

        t0 = time.perf_counter()
        compiled = squeeze("kernel").lower(seeds, ctr).compile()
        compile_s = time.perf_counter() - t0
        got = np.asarray(compiled(seeds, ctr))
        want = np.asarray(squeeze("jnp")(seeds, ctr))
        streams = int(np.prod(ctr.shape[:-1]))
        log(f"[b] {name}: {streams} streams x {nblocks} block(s), "
            f"nwords={nwords}: compile {compile_s:.2f} s")
        log(f"[b]   memory_analysis: {compiled.memory_analysis()}")
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name}: kernel != jnp Keccak")
        # hashlib on the first and last stream
        w = 34 if nwords is None else nwords
        flat_c = np.asarray(ctr).reshape(-1, 2)
        flat_s = np.asarray(jnp.broadcast_to(
            kc.align_seed(seeds, ctr), ctr.shape[:-1] + (16,))).reshape(-1, 16)
        flat_g = got.reshape(-1, got.shape[-1])
        for i in (0, streams - 1):
            c = int(flat_c[i, 0]) | (int(flat_c[i, 1]) << 32)
            h = hashlib.shake_256(flat_s[i].tobytes() + c.to_bytes(8, "little"))
            ref = np.frombuffer(h.digest(136 * nblocks), "<u4") \
                .reshape(nblocks, 34)[:, :w].reshape(-1)
            if not np.array_equal(flat_g[i], ref):
                raise AssertionError(f"{name}: stream {i} != hashlib")
        log(f"[b]   bit-equal to jnp ({got.size} words) and hashlib: True")


# ----------------------------------------------------------------- phase c

def load_golden(kind: str, n: int, L: int):
    """Golden rows in the form the API takes: sk / pk, values, seeds."""
    data = np.load(ROOT / "tests" / f"golden_{kind}_{n}_{L}.npz")
    G = sum(1 for k in data.files if k.startswith("v_"))
    g = {"G": G,
         "v": np.stack([data[f"v_{t}"] for t in range(G)]),
         "c0": np.stack([[data[f"c0_{L * t + i}"] for i in range(L)]
                         for t in range(G)]),
         "c1": np.stack([[data[f"c1_{L * t + i}"] for i in range(L)]
                         for t in range(G)])}
    if kind == "sym":
        sk_packed = bytes(data["sk_packed_0"].tolist())
        g["sk"] = np.array([((sk_packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1
                            for i in range(n)], dtype=np.int32)
    else:
        g["pk"] = (np.stack([data[f"pk0_{i}"] for i in range(L)]),
                   np.stack([data[f"pk1_{i}"] for i in range(L)]))
    return g


def batch_inputs(gold, n: int, batch: int, rng):
    """B rows of values and seeds; the first rows are the golden rows."""
    G = min(gold["G"], batch)
    values = rng.uniform(-1, 1, (batch, n // 2)).astype(np.float32)
    values[:G] = gold["v"][:G]
    share = [seed_bytes(2)] * G + [rng.bytes(64) for _ in range(batch - G)]
    err = [seed_bytes(3)] * G + [rng.bytes(64) for _ in range(batch - G)]
    return values, share, err


def check_batch(out, gold, parms):
    from seal_embedded_jax import api
    G = gold["G"]
    c0 = np.asarray(out["c0"][:, :G]).transpose(1, 0, 2)
    c1 = np.asarray(out["c1"][:, :G]).transpose(1, 0, 2)
    if not (np.array_equal(c0, gold["c0"]) and np.array_equal(c1, gold["c1"])):
        raise AssertionError("golden rows differ")
    if not bool(np.asarray(out["ok"]).all()):
        raise AssertionError("ok flag false (queue or encode overflow)")
    if not bool(api._canon_check(parms)(out["c0"], out["c1"])):
        raise AssertionError("coefficient >= modulus")


def golden_pipelines(dev):
    import jax
    from seal_embedded_jax import api
    from seal_embedded_jax.config import default_parms

    rng = np.random.default_rng(1)
    for kind, n, L in (("sym", 4096, 3), ("sym", 16384, 13),
                       ("asym", 16384, 13)):
        gold = load_golden(kind, n, L)
        parms = default_parms(n, L)
        if kind == "sym":
            ctx = api.se_setup_custom(n, L, parms.scale, api.SYM,
                                      sk=gold["sk"])
        else:
            ctx = api.se_setup_custom(n, L, parms.scale, api.ASYM,
                                      pk=gold["pk"])
        times = []
        for it in range(ITERS + 1):
            values, share, err = batch_inputs(gold, n, B, rng)
            t0 = time.perf_counter()
            out = api.se_encrypt_seeded(
                ctx, values, share_seeds=share if kind == "sym" else None,
                seeds=err)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
            check_batch(out, gold, parms)
            del out
        steady = sorted(times[1:])[len(times[1:]) // 2]
        log(f"[c] {kind} {n}/{L} B={B} encode={ctx.resolved_encode_mode()}: "
            f"first batch (compile + run) {times[0]:.2f} s, steady batch "
            f"{steady * 1e3:.2f} ms (median of {ITERS}; "
            f"{B / steady:.1f} enc/s), peak_bytes_in_use {peak_bytes(dev)}, "
            f"golden rows {gold['G']}x{L} bit-exact in {ITERS + 1} batches")


# ----------------------------------------------------------------- phase d

def encode_bits():
    import jax
    import jax.numpy as jnp
    from functools import partial
    from seal_embedded_jax import api
    from seal_embedded_jax.config import default_parms
    from seal_embedded_jax.ops.encode import decode, encode_any

    auto = api.ENCODE_BY_PLATFORM[jax.default_backend()]
    for path in sorted((ROOT / "tests").glob("golden_*.npz")):
        kind, n, L = path.stem.split("_")[1:]
        parms = default_parms(int(n), int(L))
        data = np.load(path)
        G = sum(1 for k in data.files if k.startswith("v_"))
        v = jnp.asarray(np.stack([data[f"v_{t}"] for t in range(G)]))
        pt = np.stack([data[f"pt_{t}"] for t in range(G)])
        exact = {}
        for mode in ("f64", "sf"):
            got, ok = jax.jit(partial(encode_any, parms=parms, mode=mode))(v)
            exact[mode] = bool(np.array_equal(np.asarray(got), pt)
                               and np.asarray(ok).all())
        # dd: decode-exact as tests/test_fast.py::test_encode_dd_decode_exact
        # asks — within 1e-3 after decode, within 1 of the f64 coefficients.
        dd, _ = jax.jit(partial(encode_any, parms=parms, mode="dd"))(v)
        dec = np.asarray(jax.jit(partial(decode, parms=parms))(dd))
        dd_err = float(np.abs(dec - np.asarray(v, np.float64)).max())
        dd_dist = int(np.abs(np.asarray(dd) - pt).max())
        log(f"[d] {path.name}: f64 bit-exact={exact['f64']} "
            f"sf bit-exact={exact['sf']}; dd max decode error {dd_err:.3e}, "
            f"max |dd - golden pt| {dd_dist}")
        if not exact[auto]:
            raise AssertionError(f"auto encode mode {auto!r} is not "
                                 f"bit-exact on {path.name}")
        if dd_err >= 1e-3 or dd_dist > 1:
            raise AssertionError(f"dd encode not decode-exact on {path.name}")


# ----------------------------------------------------------------- phase e

def wire_format():
    import jax.numpy as jnp
    from seal_embedded_jax import api
    from seal_embedded_jax.ckks.limbwise import make_c1_expander
    from seal_embedded_jax.config import default_parms
    from seal_embedded_jax.io import serialize
    from seal_embedded_jax.ops import keccak as kc

    gold = load_golden("sym", 4096, 3)
    parms = default_parms(4096, 3)
    ctx = api.se_setup_custom(4096, 3, parms.scale, api.SYM, sk=gold["sk"])
    rng = np.random.default_rng(2)
    values, share, err = batch_inputs(gold, 4096, 2, rng)

    sent = []
    out = api.se_encrypt_seeded(ctx, values, share_seeds=share, seeds=err,
                                send=lambda b: sent.append(b) or len(b))
    c0, c1 = np.asarray(out["c0"]), np.asarray(out["c1"])
    want = [serialize.ct_component_bytes(c[i, b]) for b in range(2)
            for i in range(3) for c in (c0, c1)]
    if sent != want:
        raise AssertionError("send: streamed components differ")

    blobs = []
    api.se_encrypt_seeded(ctx, values, share_seeds=share, seeds=err,
                          send=lambda b: blobs.append(b) or len(b),
                          send_seed_only=True)
    parsed = [serialize.seeded_ct_parse(b) for b in blobs]
    words = jnp.asarray(np.stack([kc.seed_to_words(s) for s, _ in parsed]))
    c1_rx, ok = make_c1_expander(parms, "reference")(words)
    if not (np.array_equal(np.asarray(c1_rx), c1)
            and np.array_equal(np.stack([p for _, p in parsed], 1), c0)
            and bool(np.asarray(ok).all())):
        raise AssertionError("send_seed_only: expanded c1 or c0 differ")
    log(f"[e] send: {len(sent)} components equal; send_seed_only: "
        f"{len(blobs)} blobs, expand_c1 gives back c1: True")


# ------------------------------------------------------------ four cards

def four_cards():
    import jax
    import jax.numpy as jnp
    from seal_embedded_jax import api
    from seal_embedded_jax.ckks.fast import make_fused_encryptor
    from seal_embedded_jax.config import default_parms
    from seal_embedded_jax.ops import keccak as kc
    from seal_embedded_jax.parallel.mesh import (make_mesh, shard_batch,
                                                 sym_encrypt_sharded)

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"chip_smoke --four-cards: needs 4 GPUs, found {devs}")
    n, L, per = 16384, 13, B
    parms = default_parms(n, L)
    mode = api.ENCODE_BY_PLATFORM[jax.default_backend()]
    gold = load_golden("sym", n, L)
    G = gold["G"]
    rng = np.random.default_rng(3)
    parts = [batch_inputs(gold, n, per, rng) for _ in range(4)]
    values = np.concatenate([p[0] for p in parts])
    share = np.stack([kc.seed_to_words(s) for p in parts for s in p[1]])
    err = np.stack([kc.seed_to_words(s) for p in parts for s in p[2]])

    mesh = make_mesh(n_data=4, n_limb=1, devices=devs[:4])
    fn = sym_encrypt_sharded(mesh, parms, encode_mode=mode)
    args = shard_batch(mesh, values, share, err)
    sk = jnp.asarray(gold["sk"])
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(args[0], sk, args[1], args[2]))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(args[0], sk, args[1], args[2]))
    step = time.perf_counter() - t0
    log(f"[4] sharded sym {n}/{L} B={4 * per}: first call {compile_s:.2f} s, "
        f"steady batch {step * 1e3:.2f} ms ({4 * per / step:.1f} enc/s)")

    for name in ("c0", "c1"):
        shards = out[name].addressable_shards
        owners = sorted(s.device.id for s in shards)
        rows = sorted((s.index[1].start or 0) for s in shards)
        shapes = {s.data.shape for s in shards}
        if (owners != sorted(d.id for d in devs[:4])
                or rows != [q * per for q in range(4)]
                or shapes != {(L, per, n)}):
            raise AssertionError(f"{name} is not a quarter per card: "
                                 f"{owners} {rows} {shapes}")
    log(f"[4] c0/c1 sharding {out['c0'].sharding.spec}: each of "
        f"{len(devs[:4])} cards holds ({L}, {per}, {n}) of rows "
        f"0/{per}/{2 * per}/{3 * per}+")

    one = make_fused_encryptor(parms, mode)
    with jax.default_device(devs[0]):
        for q in range(4):
            rows = slice(q * per, (q + 1) * per)
            ref = one(jnp.asarray(values[rows]), sk, jnp.asarray(share[rows]),
                      jnp.asarray(err[rows]))
            for name in ("c0", "c1", "pte", "ok"):
                sharded = np.asarray(out[name][..., rows, :]
                                     if out[name].ndim == 3
                                     else out[name][rows])
                if not np.array_equal(sharded, np.asarray(ref[name])):
                    raise AssertionError(f"card {q}: {name} != one card")
            check_batch({k: v[..., rows, :] if v.ndim == 3 else v[rows]
                         for k, v in out.items()}, gold, parms)
            del ref
    log(f"[4] golden rows {G}x{L} bit-exact on every card; sharded output "
        f"bit-equal to the one-card pipeline on the same {4 * per} rows")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the batch-sharded path on four GPUs")
    args = ap.parse_args(argv)

    import seal_embedded_jax  # noqa: F401  (x64 + compile cache)
    import jax

    dev = device_check()
    if args.four_cards:
        four_cards()
    else:
        kernel_check()
        golden_pipelines(dev)
        encode_bits()
        wire_format()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
