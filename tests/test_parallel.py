"""Multi-device sharding tests on the virtual 8-device CPU mesh:
sharded results must be bit-identical to the single-device path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seal_embedded_jax.config import Parms, PRIMES_27BIT
from seal_embedded_jax.ops.ntt import ntt
from seal_embedded_jax.parallel.coeff_ntt import ntt_coeff_sharded
from seal_embedded_jax.parallel.mesh import make_mesh, sym_encrypt_sharded

Q27 = PRIMES_27BIT[0]


@pytest.mark.parametrize("variant", ["staged", "4step"])
@pytest.mark.parametrize("n,ndev", [(256, 8), (512, 4), (64, 8)])
def test_coeff_sharded_ntt_bit_exact(n, ndev, variant):
    mesh = make_mesh(n_data=ndev, n_limb=1, devices=jax.devices()[:ndev])
    rng = np.random.default_rng(n)
    x = jnp.asarray(rng.integers(0, Q27, (3, n)).astype(np.uint32))
    got = ntt_coeff_sharded(mesh, n, Q27, axis="data", variant=variant)(x)
    want = ntt(x, Q27)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_coeff_sharded_ntt_4step_flagship_degree():
    """n=4096 over 8 devices: the production 4-step plan, panel 512x64."""
    mesh = make_mesh(n_data=8, n_limb=1)
    n = 4096
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.integers(0, Q27, (2, n)).astype(np.uint32))
    got = ntt_coeff_sharded(mesh, n, Q27, axis="data", variant="4step")(x)
    assert np.array_equal(np.asarray(got), np.asarray(ntt(x, Q27)))


def test_sym_encrypt_sharded_matches_unsharded():
    from functools import partial
    from seal_embedded_jax.ckks.sym import sym_encrypt_batch

    parms = Parms(degree=64, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)
    mesh = make_mesh(n_data=4, n_limb=2)
    B, n = 8, parms.degree
    rng = np.random.default_rng(0)
    values = jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32))
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    share = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))
    err = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))

    with mesh:
        sharded = sym_encrypt_sharded(mesh, parms)(values, sk, share, err)
    plain = jax.jit(partial(sym_encrypt_batch, parms=parms))(
        values, sk, share, err)
    for k in ("c0", "c1", "pte"):
        assert np.array_equal(np.asarray(sharded[k]), np.asarray(plain[k])), k
    assert bool(np.asarray(sharded["ok"]).all())


def _rand_inputs(parms, B, seed=0):
    n = parms.degree
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)),
            jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32)),
            jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)),
            jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)))


def test_limb_sharded_sym_bit_exact():
    """shard_map limb pipeline == single-device 'parallel' layout, bit for
    bit, on a 4x2 data x limb mesh."""
    from seal_embedded_jax.ckks.limbwise import make_limbscan_encryptor
    from seal_embedded_jax.parallel.limbwise import (
        make_limb_sharded_encryptor)

    parms = Parms(degree=512, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)
    mesh = make_mesh(n_data=4, n_limb=2)
    values, sk, share, err = _rand_inputs(parms, B=8)

    sharded = make_limb_sharded_encryptor(mesh, parms)(
        values, sk, share, err)
    plain = make_limbscan_encryptor(parms, "parallel")(
        values, sk, share, err)
    assert bool(np.asarray(sharded["ok"]).all())
    for k in ("c0", "c1", "pte"):
        assert np.array_equal(np.asarray(sharded[k]), np.asarray(plain[k])), k
    # And the limb outputs really are distributed: c0 spans all 8 devices
    # with the limb axis split (no replication of limb compute results).
    assert len(sharded["c0"].sharding.device_set) == 8
    spec = sharded["c0"].sharding.spec
    assert spec[0] == "limb" and spec[1] == "data", spec


def test_limb_sharded_asym_bit_exact():
    """Asym shard_map limb pipeline == single-device asym batch path."""
    from functools import partial
    from seal_embedded_jax.ckks.asym import asym_encrypt_batch, gen_pk_batch
    from seal_embedded_jax.parallel.limbwise import (
        make_asym_limb_sharded_encryptor)

    parms = Parms(degree=512, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)
    mesh = make_mesh(n_data=4, n_limb=2)
    n = parms.degree
    rng = np.random.default_rng(7)
    sk = jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32))
    ep = jnp.asarray(rng.integers(-20, 21, n).astype(np.int32))
    pkseed = jnp.asarray(rng.integers(0, 2 ** 32, (1, 16)).astype(np.uint32))
    pk0, pk1 = gen_pk_batch(sk, pkseed, ep, parms)
    values, _, share, _ = _rand_inputs(parms, B=8, seed=8)

    sharded = make_asym_limb_sharded_encryptor(mesh, parms)(
        values, pk0, pk1, share)
    plain = jax.jit(partial(asym_encrypt_batch, parms=parms,
                            encode_mode="f64"))(values, pk0, pk1, share)
    assert bool(np.asarray(sharded["ok"]).all())
    for k in ("c0", "c1", "pte"):
        assert np.array_equal(np.asarray(sharded[k]), np.asarray(plain[k])), k


def test_multihost_mesh_bit_exact():
    """(host=2, data=2, limb=2) virtual mesh: the multi-host encryptor
    (batch over host x data via DCN-analog axis, limbs over ICI-analog
    axis) is bit-identical to the single-device 'parallel' layout."""
    from seal_embedded_jax.ckks.limbwise import make_limbscan_encryptor
    from seal_embedded_jax.parallel import multihost as mh

    parms = Parms(degree=512, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)
    mesh = mh.make_host_mesh(n_limb=2, n_hosts=2)
    assert mesh.shape == {"host": 2, "data": 2, "limb": 2}
    values, sk, share, err = _rand_inputs(parms, B=8, seed=11)

    args = mh.shard_inputs(mesh, values, sk, share, err)
    out = mh.make_multihost_encryptor(mesh, parms)(*args)
    got = mh.collect_to_host(out)
    plain = make_limbscan_encryptor(parms, "parallel")(
        values, sk, share, err)
    assert bool(got["ok"].all())
    for k in ("c0", "c1", "pte"):
        assert np.array_equal(got[k], np.asarray(plain[k])), k
    # Batch really spans the host axis: 8 devices hold distinct shards.
    assert len(out["c0"].sharding.device_set) == 8


def test_multihost_init_noop_single_process():
    from seal_embedded_jax.parallel import multihost as mh
    assert mh.init_distributed() is False
    assert mh.init_distributed(num_processes=1) is False


# ---------------------------------------------------------------------------
# Falsifiable communication-volume assertions (SURVEY.md S2.3 comms rows):
# parse the optimized (SPMD-partitioned) HLO and pin the per-device
# collective traffic of each parallel plan against its analytic value, so
# a code change that silently doubles all-to-all traffic FAILS here even
# without multi-chip hardware.

import re

_COLL_RE = re.compile(
    r"\b(all-to-all|collective-permute|all-gather|all-reduce|reduce-scatter)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"\b(pred|[us]\d+|f\d+|bf16)\[([\d,]*)\]")
_DTYPE_BYTES = {"pred": 1, "u8": 1, "s8": 1, "u16": 2, "s16": 2, "bf16": 2,
                "f16": 2, "u32": 4, "s32": 4, "f32": 4, "u64": 8, "s64": 8,
                "f64": 8}


def _collective_volume(compiled_text):
    """{op_kind: (count, result_bytes)} over the optimized HLO — result
    bytes of each collective (for all-to-all tuples: the summed tuple),
    i.e. the per-device data volume the op touches."""
    out = {}
    for line in compiled_text.splitlines():
        m = _COLL_RE.search(line)
        if m is None or "-done" in line.split("=")[-1][:30]:
            continue
        kind = m.group(1)
        lhs = line.split(m.group(0))[0]
        nbytes = 0
        for dt, dims in _SHAPE_RE.findall(lhs):
            size = 1
            for d in dims.split(","):
                if d:
                    size *= int(d)
            nbytes += size * _DTYPE_BYTES[dt]
        cnt, tot = out.get(kind, (0, 0))
        out[kind] = (cnt + 1, tot + nbytes)
    return out


@pytest.mark.parametrize("variant,ops,per_op_factor", [
    # 4step: exactly TWO all-to-alls, each touching one full shard
    # (B_loc * S u32 words) per device; wire volume is (D-1)/D of that.
    ("4step", ("all-to-all", 2), 1.0),
    # staged: exactly log2(D) collective-permutes of one full shard each.
    ("staged", ("collective-permute", 3), 1.0),
])
def test_coeff_ntt_collective_volume(variant, ops, per_op_factor):
    from seal_embedded_jax.parallel.coeff_ntt import _sharded_ntt_cache
    from jax.sharding import NamedSharding, PartitionSpec as P

    D, n, B = 8, 4096, 4
    mesh = make_mesh(n_data=D, n_limb=1)
    fn = _sharded_ntt_cache(mesh, n, Q27, "data", 1, variant)
    x = jax.device_put(jnp.zeros((B, n), jnp.uint32),
                       NamedSharding(mesh, P(None, "data")))
    vol = _collective_volume(fn.lower(x).compile().as_text())
    kind, expect_count = ops
    shard_bytes = B * (n // D) * 4
    count, nbytes = vol.pop(kind)
    assert count == expect_count, (variant, count, vol)
    assert nbytes == int(expect_count * shard_bytes * per_op_factor), \
        (variant, nbytes, shard_bytes)
    # No other collective may appear in the NTT plan at all.
    assert vol == {}, vol


def test_multihost_pipeline_collective_volume():
    """The (host, data, limb) pipeline's collectives carry ONLY the
    limb-axis input broadcast (pte + seed words) and the ok-flag
    reduction — never ciphertext-sized data (the multihost.py design
    claim: DCN/batch axes see zero collectives; adding any c0/c1-sized
    exchange, ~L_loc*B_loc*n*4 bytes, would more than double the bound
    asserted here)."""
    from seal_embedded_jax.parallel import multihost as mh

    parms = Parms(degree=512, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)
    mesh = mh.make_host_mesh(n_limb=2, n_hosts=2)
    B, n = 8, parms.degree
    values, sk, share, err = _rand_inputs(parms, B=B, seed=3)
    args = mh.shard_inputs(mesh, values, sk, share, err)
    fn = mh.make_multihost_encryptor(mesh, parms)
    vol = _collective_volume(fn.lower(*args).compile().as_text())

    total = sum(b for _, b in vol.values())
    # Analytic: all-gather of pte over the limb axis (result rows =
    # B / (host*data) per device, i64) + the share_words gather (u32 x16)
    # + the pred ok reduce.  Everything else would be a regression.
    rows = B // (mesh.shape["host"] * mesh.shape["data"])
    analytic = rows * n * 8 + rows * 16 * 4 + rows
    assert total <= int(analytic * 1.05) + 64, (vol, analytic)
    # and specifically no butterfly/transpose exchange anywhere: the limb
    # pipeline is embarrassingly parallel past the input broadcast.
    assert "all-to-all" not in vol and "collective-permute" not in vol, vol
    assert sum(c for c, _ in vol.values()) <= 4, vol
