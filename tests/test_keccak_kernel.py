"""The SHAKE-256 squeeze kernel (ops/kernels/keccak.py) in Pallas interpret
mode, its dispatch, and the platform choices around it.

The kernel is bit-compared with hashlib's SHAKE-256 and with the jnp
Keccak, and the fused sym / asym pipelines run with it forced on against
the C-reference golden vectors.  On a GPU, chip_smoke.py checks the
compiled kernel at the pipelines' real widths.
"""

import hashlib
import os
import pathlib
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import seal_embedded_jax
from seal_embedded_jax import api
from seal_embedded_jax.config import default_parms
from seal_embedded_jax.ops import keccak as kc
from seal_embedded_jax.ops import sampling as sp
from seal_embedded_jax.ops.kernels import keccak as kk

from conftest import seed_bytes

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _hashlib_words(seed_words, ctr, nblocks, nwords):
    c = int(ctr[0]) | (int(ctr[1]) << 32)
    digest = hashlib.shake_256(np.asarray(seed_words, "<u4").tobytes()
                               + c.to_bytes(8, "little")).digest(136 * nblocks)
    w = 34 if nwords is None else nwords
    return np.frombuffer(digest, "<u4").reshape(nblocks, 34)[:, :w].reshape(-1)


@pytest.mark.parametrize("nwords", [None, 1, 24])
@pytest.mark.parametrize("nblocks", [1, 2, 3])
def test_kernel_vs_hashlib_and_jnp(nblocks, nwords):
    """Interpret-mode kernel == hashlib == jnp Keccak, with a stream count
    that is not a multiple of the program width (padding)."""
    bs, _ = kk.launch_shape(nblocks)
    N = bs + 5
    rng = np.random.default_rng(100 * nblocks + (nwords or 0))
    sw = rng.integers(0, 2 ** 32, (N, 16), dtype=np.uint32)
    ctr = rng.integers(0, 2 ** 32, (N, 2), dtype=np.uint32)
    sw[0] = kc.seed_to_words(seed_bytes(2))
    ctr[0] = [0, 0]

    def run(impl):
        return np.asarray(jax.jit(lambda s, c: kc.shake256_words(
            s, c, nblocks, impl=impl, nwords=nwords))(sw, ctr))

    got = run("interpret")
    w = 34 if nwords is None else nwords
    assert got.shape == (N, nblocks * w)
    assert np.array_equal(got, run("jnp"))
    for i in (0, 1, N - 1):
        assert np.array_equal(got[i], _hashlib_words(sw[i], ctr[i], nblocks,
                                                     nwords)), i


def test_kernel_queue_layout_broadcasts_seeds():
    """The samplers' queue call: one seed per message, (B, cap) counters,
    nwords=1 — output (B, cap, 1), each entry its own stream."""
    B, cap = 3, 7
    rng = np.random.default_rng(5)
    sw = jnp.asarray(rng.integers(0, 2 ** 32, (B, 16), dtype=np.uint32))
    ctr = sp._c_offsets(sp.counter_zero((B,)) + jnp.uint32(0xFFFFFFFE),
                        1 + jnp.arange(cap, dtype=jnp.uint32))
    got = np.asarray(kc.shake256_words(sw, ctr, 1, impl="interpret",
                                       nwords=1))
    assert got.shape == (B, cap, 1)
    want = np.asarray(kc.shake256_words(sw, ctr, 1, impl="jnp", nwords=1))
    assert np.array_equal(got, want)
    c = np.asarray(ctr)
    for b, j in ((0, 0), (2, 6), (1, 3)):
        assert got[b, j, 0] == _hashlib_words(np.asarray(sw)[b], c[b, j],
                                              1, 1)[0]


@pytest.mark.parametrize("nblocks,streams,warps", [(1, 128, 4), (482, 32, 1)])
def test_launch_shape(nblocks, streams, warps):
    """Single-block calls take four warps per program; long squeezes one,
    so B streams spread over B/32 programs."""
    assert kk.launch_shape(nblocks) == (streams, warps)


def _golden_sym_rows(n, L, rows):
    data = np.load(ROOT / "tests" / f"golden_sym_{n}_{L}.npz")
    sk_packed = bytes(data["sk_packed_0"].tolist())
    sk = np.array([((sk_packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1
                   for i in range(n)], dtype=np.int32)
    vs = np.stack([data[f"v_{t}"] for t in range(rows)])
    c0 = [[data[f"c0_{L * t + i}"] for i in range(L)] for t in range(rows)]
    c1 = [[data[f"c1_{L * t + i}"] for i in range(L)] for t in range(rows)]
    return sk, vs, c0, c1


@pytest.fixture
def kernel_forced(monkeypatch):
    """Every SHAKE call of a pipeline goes through the kernel, interpreted."""
    monkeypatch.setattr(kc, "default_impl", lambda: "interpret")


@pytest.mark.parametrize("n,L", [(1024, 1), (4096, 3)])
def test_fused_sym_kernel_golden(n, L, kernel_forced):
    """Fused symmetric pipeline with every squeeze in the kernel ==
    C-reference golden ciphertexts."""
    from seal_embedded_jax.ckks.fast import sym_encrypt_fused

    P = default_parms(n, L)
    rows = 2
    sk, vs, c0, c1 = _golden_sym_rows(n, L, rows)
    share = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(2)), (rows, 1)))
    err = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(3)), (rows, 1)))
    out = jax.jit(partial(sym_encrypt_fused, parms=P, encode_mode="f64"))(
        jnp.asarray(vs), jnp.asarray(sk), share, err)
    assert bool(np.asarray(out["ok"]).all())
    for b in range(rows):
        for i in range(L):
            assert np.array_equal(np.asarray(out["c0"])[i, b], c0[b][i])
            assert np.array_equal(np.asarray(out["c1"])[i, b], c1[b][i])


def test_fused_asym_kernel_golden(kernel_forced):
    """Fused public-key pipeline with every squeeze in the kernel ==
    C-reference golden ciphertexts (n=4096, 3 primes)."""
    from seal_embedded_jax.ckks.asym import asym_encrypt_fused

    data = np.load(ROOT / "tests" / "golden_asym_4096_3.npz")
    P = default_parms(4096, 3)
    L, rows = P.nprimes, 2
    vs = np.stack([data[f"v_{t}"] for t in range(rows)])
    pk0 = jnp.asarray(np.stack([data[f"pk0_{i}"] for i in range(L)]))
    pk1 = jnp.asarray(np.stack([data[f"pk1_{i}"] for i in range(L)]))
    seeds = jnp.asarray(np.tile(kc.seed_to_words(seed_bytes(3)), (rows, 1)))
    out = jax.jit(partial(asym_encrypt_fused, parms=P, encode_mode="f64"))(
        jnp.asarray(vs), pk0, pk1, seeds)
    assert bool(np.asarray(out["ok"]).all())
    for b in range(rows):
        for i in range(L):
            assert np.array_equal(np.asarray(out["c0"])[i, b],
                                  data[f"c0_{L * b + i}"])
            assert np.array_equal(np.asarray(out["c1"])[i, b],
                                  data[f"c1_{L * b + i}"])


@pytest.mark.parametrize("platform,impl", [("gpu", "kernel"), ("cpu", "jnp")])
def test_default_impl_by_platform(platform, impl, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert kc.default_impl() == impl


def test_unknown_impl_rejected():
    with pytest.raises(ValueError):
        kc.shake256_words(np.zeros((1, 16), np.uint32),
                          np.zeros((1, 2), np.uint32), 1, impl="tile")


@pytest.mark.parametrize("platform,mode", [("gpu", "f64"), ("cpu", "f64"),
                                           ("rocm", "sf")])
def test_resolved_encode_mode_by_platform(platform, mode, monkeypatch):
    """'auto' picks the backend's bit-exact encode; an explicit mode wins."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    ctx = api.SEContext(parms=default_parms(1024, 1), encrypt_type=api.SYM)
    assert ctx.resolved_encode_mode() == mode
    ctx.encode_mode = "dd"
    assert ctx.resolved_encode_mode() == "dd"


def _cache_dir_in_fresh_process(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import seal_embedded_jax, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_value", [None, "/var/cache/elsewhere"])
def test_compile_cache_dir(env_value, monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is the fixed .jax_cache
    of the checkout; with it, the package sets nothing and JAX uses it."""
    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(ROOT / ".jax_cache")
        assert seal_embedded_jax.compile_cache_dir() == want
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
        want = env_value
        assert seal_embedded_jax.compile_cache_dir() is None
    assert _cache_dir_in_fresh_process(env_value) == want


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line on the CPU,
    and in a directory that holds nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        cwd = tmp_path
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
