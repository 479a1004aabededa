"""Multi-host (DCN) scale-out for the CKKS encrypt pipelines.

The reference is a single-core embedded library with no distribution at
all; scale-out is a new design axis (SURVEY.md §2.3 "Multi-host" row).
The plan follows the standard JAX multi-host recipe:

* one process per host joins via ``jax.distributed.initialize`` (wrapped
  in :func:`init_distributed`);
* the global device mesh is (host, data, limb): the *batch* of messages
  shards over ``host`` × ``data`` — host boundaries only ever cut the
  embarrassingly-parallel batch axis, so the **only DCN traffic is input
  distribution and output collection**, never per-butterfly exchange;
* RNS limbs shard over ``limb`` (ICI within a host, exactly as in
  parallel/limbwise.py — the shard_mapped limb pipeline is reused
  unchanged with a composite batch axis);
* coefficient-sharded NTT (parallel/coeff_ntt.py), when enabled, also
  stays within a host's ICI domain.

This keeps the DCN:ICI traffic ratio at the theoretical minimum (DCN
carries exactly B/n_hosts · (n/2 f32 in + L·2·n u32 out) per host per
batch, zero collectives), which is what makes near-linear host scaling
achievable: steady-state throughput = n_hosts × single-host throughput
as long as the host-side input feed keeps up.

Single-process testing: every function below works with a mesh built
from local (or virtual ``--xla_force_host_platform_device_count``)
devices — a (2, 2, 2) virtual mesh exercises the identical GSPMD
partitioning and collectives that a real 2-host run would produce,
minus the physical DCN transport (tests/test_parallel.py).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Parms


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join the multi-host runtime (one call per process, before any jax
    computation).  No-ops (returns False) when single-process — so the
    same entry point runs unmodified on one host or many."""
    if num_processes is None or num_processes <= 1:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_host_mesh(n_limb: int = 1, devices=None,
                   n_hosts: int | None = None) -> Mesh:
    """Global (host, data, limb) mesh.

    On a real multi-host slice, ``jax.devices()`` (after
    init_distributed) returns the global device list ordered by process;
    the leading mesh axis then aligns with host boundaries, so 'data' and
    'limb' collectives stay on ICI.  Single-process: pass ``n_hosts`` to
    emulate the same topology on local/virtual devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    n = len(devices)
    assert n % (n_hosts * n_limb) == 0, (n, n_hosts, n_limb)
    dev_array = np.array(devices).reshape(n_hosts, n // (n_hosts * n_limb),
                                          n_limb)
    return Mesh(dev_array, ("host", "data", "limb"))


@lru_cache(maxsize=16)
def make_multihost_encryptor(mesh: Mesh, parms: Parms,
                             encode_mode: str = "f64"):
    """Symmetric batched encode+encrypt over a (host, data, limb) mesh.

    The batch shards over the composite ('host', 'data') axis pair and
    limbs over 'limb' — the limb pipeline is parallel/limbwise.py's
    shard_map body verbatim, with the batch axis name widened.  Outputs:
    c0/c1 (L, B, n) sharded P('limb', ('host', 'data'), None).

    Bit-identical to the single-device "parallel"-layout pipeline for any
    mesh shape (asserted on the virtual (2,2,2) CPU mesh)."""
    from .limbwise import make_limb_sharded_encryptor
    return make_limb_sharded_encryptor(mesh, parms, encode_mode,
                                       data_axis=("host", "data"),
                                       limb_axis="limb")


def shard_inputs(mesh: Mesh, values, sk_signed, share_words, err_words):
    """Place batched inputs: batch over ('host','data')×'limb' combined
    (each process only materializes its addressable shards — the DCN
    input-feed path), sk replicated."""
    batch_sh = NamedSharding(mesh, P(("host", "data", "limb"), None))
    rep = NamedSharding(mesh, P(None))
    return (jax.device_put(values, batch_sh), jax.device_put(sk_signed, rep),
            jax.device_put(share_words, batch_sh),
            jax.device_put(err_words, batch_sh))


def collect_to_host(out) -> dict:
    """Gather a sharded output dict to host-local numpy for serialization
    (the reference's send-over-network seam, seal_embedded.c:180-204).

    Single-process meshes: a plain device_get.  Multi-process: each host
    fetches its addressable ciphertext shards only, returned as a list of
    ``(index, array)`` pairs per key — ``index`` is the shard's global
    placement (tuple of slices into the global array, ``Shard.index``), so
    hosts can reconstruct exactly which batch/limb positions they hold
    (a bare stack would mix batch and limb shards in device order with no
    way back to global coordinates).  Streaming each limb component as
    produced is ckks/stream.py's job; use
    ``jax.experimental.multihost_utils.process_allgather`` instead when
    every host needs the full ciphertext."""
    if jax.process_count() <= 1:
        return {k: np.asarray(v) for k, v in out.items()}
    return {k: [(s.index, np.asarray(s.data)) for s in v.addressable_shards]
            for k, v in out.items()}
