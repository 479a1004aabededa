"""Public API: the seal_embedded.h surface, batched on an accelerator.

Mirrors the reference's public API (device/lib/seal_embedded.{h,c}:
se_setup[_custom,_default], se_encrypt[_seeded], se_cleanup) with a batched,
jit-compiled implementation.  The reference's SEND_FNCT_PTR network seam
(seal_embedded.h:61-65) maps to a per-component callback invoked with the
serialized bytes of each RNS component as it is produced.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ckks.asym import gen_pk_batch, make_fused_asym_encryptor
from .ckks.fast import make_fused_encryptor
from .config import Parms, default_parms
from .io import serialize
from .ops import keccak as kc
from .ops import sampling as sp

SYM = "sym"
ASYM = "asym"

# Bit-exact encode per backend ('auto'): native f64 where XLA rounds every
# f64 multiply and add on its own, as the C reference does.
ENCODE_BY_PLATFORM = {"cpu": "f64", "gpu": "f64"}


@dataclasses.dataclass
class SEContext:
    """Equivalent of SE_PARMS: parameters + key material + compiled graphs.

    encode_mode: 'auto' (the bit-exact mode of the default backend,
    ENCODE_BY_PLATFORM; 'sf' on any other backend), or force 'f64' /
    'sf' / 'dd'.
    """
    parms: Parms
    encrypt_type: str
    sk_signed: Optional[np.ndarray] = None       # {-1,0,1} (n,)
    pk0: Optional[np.ndarray] = None             # (nprimes, n) NTT form
    pk1: Optional[np.ndarray] = None
    encode_mode: str = "auto"
    _sym_fn: Optional[Callable] = None
    _asym_fn: Optional[Callable] = None

    @property
    def degree(self) -> int:
        return self.parms.degree

    def resolved_encode_mode(self) -> str:
        if self.encode_mode != "auto":
            return self.encode_mode
        return ENCODE_BY_PLATFORM.get(jax.default_backend(), "sf")


def _seed_words_batch(seeds: list[bytes]) -> jnp.ndarray:
    return jnp.asarray(
        np.stack([kc.seed_to_words(s) for s in seeds]).astype(np.uint32))


def sample_sk_from_seed(parms: Parms, seed: bytes) -> np.ndarray:
    """Deterministic ternary secret key from a 64-byte seed, identical to the
    reference's sample_s path (ckks_sym.c:162-179)."""
    from .golden.prng import Prng
    from .golden.sampling import sample_small_poly_ternary_96, ternary_signed
    packed = sample_small_poly_ternary_96(parms.degree, Prng(seed))
    return np.array(ternary_signed(packed, parms.degree), dtype=np.int32)


def se_setup_custom(degree: int, nprimes: int, scale: float,
                    encrypt_type: str = SYM,
                    sk: Optional[np.ndarray] = None,
                    sk_seed: Optional[bytes] = None,
                    sk_path: Optional[str] = None,
                    pk_dir: Optional[str] = None,
                    pk_seed: Optional[bytes] = None,
                    pk: Optional[tuple[np.ndarray, np.ndarray]] = None,
                    encode_mode: str = "auto") -> SEContext:
    """se_setup_custom equivalent (seal_embedded.c:24-83).

    Secret key sources (priority): explicit `sk` ({-1,0,1} array), `sk_seed`
    (sampled like the reference), `sk_path` (2-bit packed .dat file).
    For asym, the pk is given as `pk` = (pk0, pk1) (NTT form, (nprimes,
    n) each), loads from `pk_dir` (.dat files, NTT form), or is generated
    device-side from sk + pk_seed (gen_pk).
    """
    parms = default_parms(degree, nprimes, scale)
    ctx = SEContext(parms=parms, encrypt_type=encrypt_type,
                    encode_mode=encode_mode)

    n = degree
    if sk is not None:
        ctx.sk_signed = np.asarray(sk, dtype=np.int32)
    elif sk_seed is not None:
        ctx.sk_signed = sample_sk_from_seed(parms, sk_seed)
    elif sk_path is not None:
        packed = serialize.read_sk(sk_path, n)
        vals = serialize.unpack_ternary(packed, n)
        ctx.sk_signed = np.array([v - 1 for v in vals], dtype=np.int32)

    if encrypt_type == ASYM:
        if pk is not None:
            ctx.pk0, ctx.pk1 = (np.asarray(p, dtype=np.uint32) for p in pk)
        elif pk_dir is not None:
            pk0 = np.stack([
                serialize.read_pk_component(pk_dir, 0, n, q)
                for q in parms.moduli])
            pk1 = np.stack([
                serialize.read_pk_component(pk_dir, 1, n, q)
                for q in parms.moduli])
            ctx.pk0, ctx.pk1 = pk0, pk1
        else:
            assert ctx.sk_signed is not None, "need sk to generate pk"
            seed = pk_seed or os.urandom(64)
            sw = jnp.asarray(kc.seed_to_words(seed)[None, :])
            import hashlib
            ep_seed = hashlib.shake_256(seed + b"ep").digest(64)
            from .golden.prng import Prng
            from .golden.sampling import sample_poly_cbd_16
            ep = np.array(sample_poly_cbd_16(n, Prng(ep_seed)), dtype=np.int32)
            pk0, pk1 = gen_pk_batch(
                jnp.asarray(ctx.sk_signed), sw, jnp.asarray(ep), parms)
            ctx.pk0, ctx.pk1 = np.asarray(pk0), np.asarray(pk1)

    return ctx


def se_setup(degree: int = 4096, nprimes: int = 3,
             scale: float | None = None, encrypt_type: str = SYM,
             **kw) -> SEContext:
    parms = default_parms(degree, nprimes, scale)
    return se_setup_custom(degree, nprimes, parms.scale, encrypt_type, **kw)


def se_setup_default(encrypt_type: str = SYM, **kw) -> SEContext:
    """n=4096, 3 primes, scale 2^25 (seal_embedded.c:90-96)."""
    return se_setup(4096, 3, 2.0 ** 25, encrypt_type, **kw)


def se_encrypt_seeded(ctx: SEContext, values: np.ndarray,
                      share_seeds: Optional[list[bytes]] = None,
                      seeds: Optional[list[bytes]] = None,
                      send: Optional[Callable[[bytes], int]] = None,
                      send_seed_only: bool = False):
    """se_encrypt_seeded equivalent (seal_embedded.c:98-215), batched.

    values: (B, <= n/2) float32.  seeds: per-message 64-byte seeds (random
    if omitted).  If `send` is given it receives each RNS component's bytes
    in the reference's streaming order (c0 then c1, per prime, per message).
    With send_seed_only (symmetric only) each message is sent as ONE
    compressed blob: the 64-byte shareable seed + c0 per prime; the
    receiver expands c1 via ckks.limbwise.expand_c1 (the reference's
    unfinished SE_ENABLE_SYM_SEED_CT, seal_embedded.c:184-194).
    Returns dict of device arrays (see sym_encrypt_fused / asym_encrypt_fused).
    """
    values = np.atleast_2d(np.asarray(values, dtype=np.float32))
    B = values.shape[0]
    n = ctx.parms.degree
    assert values.shape[1] <= n // 2
    if values.shape[1] < n // 2:
        values = np.pad(values, ((0, 0), (0, n // 2 - values.shape[1])))

    seeds = seeds or [os.urandom(64) for _ in range(B)]
    mode = ctx.resolved_encode_mode()
    if ctx.encrypt_type == SYM:
        share_seeds = share_seeds or [os.urandom(64) for _ in range(B)]
        fn = make_fused_encryptor(ctx.parms, mode)
        out = fn(jnp.asarray(values), jnp.asarray(ctx.sk_signed),
                 _seed_words_batch(share_seeds), _seed_words_batch(seeds))
    else:
        fn = make_fused_asym_encryptor(ctx.parms, mode)
        out = fn(jnp.asarray(values), jnp.asarray(ctx.pk0),
                 jnp.asarray(ctx.pk1), _seed_words_batch(seeds))

    if send is not None:
        # Sanity check before anything leaves the device: every ciphertext
        # coefficient must be canonical, < its prime (seal_embedded.c:172-177).
        # Runs ON DEVICE as a reduction — the host fetches one boolean, not
        # an extra (L, B, n) pass (the component fetches below are the only
        # bulk transfers on the send path).
        check_c1 = not send_seed_only
        if not bool(_canon_check(ctx.parms)(
                out["c0"], out["c1"] if check_c1 else out["c0"])):
            raise ValueError("ciphertext coefficient >= modulus")
        c0 = np.asarray(out["c0"])
        if send_seed_only:
            assert ctx.encrypt_type == SYM, "seed-only cts are symmetric"
            for b in range(B):
                send(serialize.seeded_ct_bytes(share_seeds[b], c0[:, b]))
        else:
            c1 = np.asarray(out["c1"])
            for b in range(B):
                for i in range(ctx.parms.nprimes):
                    send(serialize.ct_component_bytes(c0[i, b]))
                    send(serialize.ct_component_bytes(c1[i, b]))
    return out


from functools import lru_cache


@lru_cache(maxsize=16)
def _canon_check(parms: Parms):
    """On-device canonicality reduction: all coefficients of both
    components < their limb's prime (seal_embedded.c:172-177)."""
    qs = np.asarray(parms.moduli, dtype=np.uint32)[:, None, None]

    def check(c0, c1):
        q = jnp.asarray(qs)
        return jnp.all(c0 < q) & jnp.all(c1 < q)

    return jax.jit(check)


def se_encrypt(ctx: SEContext, values: np.ndarray,
               send: Optional[Callable[[bytes], int]] = None):
    """se_encrypt equivalent: random seeds per message."""
    return se_encrypt_seeded(ctx, values, send=send)


def se_decrypt_decode(ctx: SEContext, out, prime_idx: int = 0) -> np.ndarray:
    """Verification oracle: decrypt+decode a batch result (test-side only,
    like the reference's check_decode_decrypt_inpl)."""
    from .ckks.sym import make_decryptor
    from .ops.encode import make_decoder
    centered = make_decryptor(ctx.parms)(
        out["c0"], out["c1"], jnp.asarray(ctx.sk_signed))
    return np.asarray(make_decoder(ctx.parms)(centered[prime_idx]))


def se_cleanup(ctx: SEContext) -> None:
    """Drop key material (the reference's se_cleanup + se_secure_zero_memset
    discipline, seal_embedded.c:217-233, defines.h:405-409).

    Host copies of sk/pk are zeroed in place before the references are
    dropped, so the Python heap does not retain plaintext key bytes.
    Threat-model note vs the reference: the reference volatile-memsets a
    single mempool on a device it fully controls.  Here, transient device
    (HBM) copies of the key are created per encrypt call and freed by
    JAX's allocator when the call's arrays die — device memory is not
    accessible to other processes on a healthy host, but freed pages are
    NOT scrubbed by the runtime; for stronger guarantees keep contexts
    short-lived and call se_cleanup as soon as the last batch is
    dispatched.  Compiled
    executables cache no key values (keys are runtime arguments, never
    trace-time constants)."""
    for name in ("sk_signed", "pk0", "pk1"):
        buf = getattr(ctx, name)
        if buf is not None and isinstance(buf, np.ndarray):
            try:
                buf.setflags(write=True)
                buf.fill(0)
            except ValueError:
                pass  # non-owning view; the reference we drop is all we have
        setattr(ctx, name, None)
    ctx._sym_fn = None
    ctx._asym_fn = None


def print_config(ctx: SEContext) -> str:
    """Runtime configuration banner — the reference's print_config
    (util_print.h:713) maps compile-time #defines to these runtime fields."""
    p = ctx.parms
    lines = [
        "seal_embedded_jax configuration",
        f"  backend          : {jax.default_backend()} "
        f"({len(jax.devices())} device(s))",
        f"  degree n         : {p.degree}",
        f"  modulus chain    : {list(p.moduli)}",
        f"  scale            : 2^{int(np.log2(p.scale))}",
        f"  encrypt type     : {ctx.encrypt_type}",
        f"  encode mode      : {ctx.encode_mode} "
        f"(resolved: {ctx.resolved_encode_mode()})",
        f"  sk loaded        : {ctx.sk_signed is not None}",
        f"  pk loaded        : {ctx.pk0 is not None}",
    ]
    banner = "\n".join(lines)
    print(banner)
    return banner
