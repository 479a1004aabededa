"""Checkpointed batch restart: journaled inputs re-run to bit-identical
ciphertexts; crashes (simulated by dropping the DONE record) are
recovered exactly; ok=False batches journal FAILED."""

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from seal_embedded_jax.config import Parms, PRIMES_27BIT
from seal_embedded_jax.ckks.limbwise import sym_encrypt_limbscan
from seal_embedded_jax.utils.checkpoint import (CheckpointJournal,
                                                CheckpointedRunner)

PARMS = Parms(degree=64, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)


def _inputs(seed, B=3):
    n = PARMS.degree
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)),
            jnp.asarray((rng.integers(0, 3, n) - 1).astype(np.int32)),
            jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)),
            jnp.asarray(rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)))


def test_restart_is_bit_exact(tmp_path):
    fn = jax.jit(partial(sym_encrypt_limbscan, parms=PARMS))
    values, sk, share, err = _inputs(0)

    j1 = CheckpointJournal(str(tmp_path))
    r1 = CheckpointedRunner(j1, fn)
    sent = {}
    out0 = r1.run(0, values, sk, share, err,
                  on_output=lambda b, o: sent.setdefault(b, np.asarray(o["c0"])))
    assert out0 is not None and 0 in sent
    # Batch 1 "crashes" after begin (no done record written).
    j1.begin(1, {"values": np.asarray(values),
                 "share_words": np.asarray(share),
                 "err_words": np.asarray(err)})
    assert j1.scan() == {0: "done", 1: "pending"}

    # New process: resume re-runs exactly the pending batch, bit-identical.
    j2 = CheckpointJournal(str(tmp_path))
    r2 = CheckpointedRunner(j2, fn)
    outs = r2.resume(sk)
    assert list(outs) == [1]
    assert np.array_equal(np.asarray(outs[1]["c0"]), np.asarray(out0["c0"]))
    assert j2.scan() == {0: "done", 1: "done"}


def test_failed_batch_journals(tmp_path):
    def bad_fn(values, sk, share, err):
        return {"ok": jnp.zeros((values.shape[0],), bool)}

    j = CheckpointJournal(str(tmp_path))
    r = CheckpointedRunner(j, bad_fn)
    values, sk, share, err = _inputs(1)
    assert r.run(7, values, sk, share, err) is None
    assert j.scan() == {7: "failed"}


def test_pending_raises_on_lost_inputs(tmp_path):
    """A durable PENDING record whose inputs npz is missing is exactly the
    data loss the write-ahead journal exists to surface: pending() (and
    therefore resume()) must raise, not silently skip (ADVICE r3)."""
    import os
    import pytest

    j = CheckpointJournal(str(tmp_path))
    values, sk, share, err = _inputs(3)
    j.begin(7, {"values": np.asarray(values),
                "share_words": np.asarray(share),
                "err_words": np.asarray(err)})
    os.remove(tmp_path / "batch_7_inputs.npz")
    with pytest.raises(RuntimeError, match="missing or corrupt"):
        j.pending()
    # corrupt (truncated) file raises too
    j.begin(8, {"values": np.asarray(values),
                "share_words": np.asarray(share),
                "err_words": np.asarray(err)})
    with open(tmp_path / "batch_8_inputs.npz", "wb") as f:
        f.write(b"PK\x03\x04truncated")
    with pytest.raises(RuntimeError, match="missing or corrupt"):
        j.pending()


def test_begin_writes_inputs_atomically(tmp_path):
    """begin() must never leave a PENDING record without a complete npz:
    the inputs file appears via fsync+rename BEFORE the journal line."""
    import os

    j = CheckpointJournal(str(tmp_path))
    values, sk, share, err = _inputs(4)
    j.begin(9, {"values": np.asarray(values)})
    # no temp residue, npz loadable, journal has the record
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    data = dict(np.load(tmp_path / "batch_9_inputs.npz"))
    assert np.array_equal(data["values"], np.asarray(values))
    assert j.scan() == {9: "pending"}
