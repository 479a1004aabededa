"""Device mesh + sharded encryption entry points.

Parallelism axes for CKKS encode/encrypt (SURVEY.md S2.3):
  data  — batch of independent messages (DP): embarrassingly parallel
  limb  — RNS primes (TP-like): each prime's NTT/sampling is independent

The batch-sharded pipeline needs no collectives (each message is
independent).  Coefficient sharding (sequence-parallel NTT) is a separate
path in parallel/coeff_ntt.py.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Parms


def make_mesh(n_data: int | None = None, n_limb: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_data is None:
        n_data = n // n_limb
    assert n_data * n_limb == n, (n_data, n_limb, n)
    dev_array = np.array(devices).reshape(n_data, n_limb)
    return Mesh(dev_array, ("data", "limb"))


def shard_batch(mesh: Mesh, *arrays):
    """Place batched arrays with the batch axis sharded over 'data'."""
    sh = NamedSharding(mesh, P("data"))
    return tuple(jax.device_put(a, sh) for a in arrays)


def sym_encrypt_sharded(mesh: Mesh, parms: Parms, encode_mode: str = "f64"):
    """Batch-sharded symmetric encrypt: each device of the 'data' axis runs
    the one-device pipeline (ckks.fast.sym_encrypt_fused) on its slice of
    the batch, under shard_map, so the SHAKE kernel sees local shapes and
    no device computes another's rows.  Devices along 'limb' (if any) hold
    replicas.  Outputs: c0/c1 (L, B, n) sharded on B, pt/pte/ok on B.

    For limb-parallel compute (each device owns its primes end-to-end)
    use parallel.limbwise.make_limb_sharded_encryptor instead.
    """
    from ..ckks.fast import sym_encrypt_fused

    batch = P("data")
    out_specs = {"c0": P(None, "data"), "c1": P(None, "data"),
                 "pt": batch, "pte": batch, "ok": batch}
    fn = jax.shard_map(
        partial(sym_encrypt_fused, parms=parms, encode_mode=encode_mode),
        mesh=mesh, in_specs=(batch, P(), batch, batch),
        out_specs=out_specs, check_vma=False)
    return jax.jit(fn)
