"""Batch checkpoint/restart for long encryption runs.

The reference has no failure recovery at all (SURVEY.md §5: se_assert
aborts; the only persistent state is the adapter's precompute directory).
For an accelerator fleet pushing 10^5+ encryptions/sec, the failure unit is a
*batch*: a preemption, an `ok=False` flag (sampler-queue overflow /
encode overflow / no-subnormal guard) or a host crash should cost one
batch of work, not the run.  This module provides the minimal journal
that makes batch restarts exact:

* the PRNG inputs (seed words + starting counters) and the batch's
  position in the stream are the *complete* state of a CKKS encrypt
  batch — the pipelines are pure functions of them, so re-running a
  journaled batch reproduces the identical ciphertexts (bit-exact
  restart, same property the golden tests pin);
* the journal is an append-only jsonl + npz pair per batch window —
  write-ahead (PENDING) before dispatch, marked DONE after the outputs
  are serialized/sent, so a scan at startup yields exactly the batches
  to re-run;
* nothing here touches the compute path: wrap any batched encryptor
  (fused / limbwise / sharded) with `CheckpointedRunner.run`.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np


@dataclass
class BatchRecord:
    batch_id: int
    status: str          # "pending" | "done" | "failed"
    meta: dict

    def to_json(self) -> str:
        return json.dumps({"batch_id": self.batch_id,
                           "status": self.status, "meta": self.meta})


class CheckpointJournal:
    """Append-only journal of batch attempts in `dirpath`.

    Layout: journal.jsonl (one record per transition) plus
    batch_<id>_inputs.npz (seed words, counters, values hash) written
    before dispatch."""

    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.path = os.path.join(dirpath, "journal.jsonl")

    def _fsync_dir(self) -> None:
        """fsync the journal directory so renames/appends are durably
        visible before any record that depends on them."""
        fd = os.open(self.dirpath, os.O_DIRECTORY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _append(self, rec: BatchRecord) -> None:
        with open(self.path, "a") as f:
            f.write(rec.to_json() + "\n")
            f.flush()
            os.fsync(f.fileno())

    def begin(self, batch_id: int, inputs: dict, meta: dict | None = None):
        """Write-ahead: persist inputs durably, then journal PENDING.

        The npz is written to a temp file, fsynced and atomically renamed
        BEFORE the PENDING record is appended — a crash can leave an
        orphan npz (harmless) but never a durable PENDING record pointing
        at a missing or truncated inputs file."""
        final = os.path.join(self.dirpath, f"batch_{batch_id}_inputs.npz")
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **inputs)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        # fsync the directory: the renamed npz's directory entry must be
        # durable before the PENDING record is (file fsync alone does not
        # order the rename against the journal append).
        self._fsync_dir()
        self._append(BatchRecord(batch_id, "pending",
                                 dict(meta or {}, ts=time.time())))

    def done(self, batch_id: int, meta: dict | None = None):
        self._append(BatchRecord(batch_id, "done",
                                 dict(meta or {}, ts=time.time())))

    def failed(self, batch_id: int, reason: str):
        self._append(BatchRecord(batch_id, "failed",
                                 {"reason": reason, "ts": time.time()}))

    def scan(self) -> dict:
        """Latest status per batch_id."""
        out: dict[int, str] = {}
        if not os.path.exists(self.path):
            return out
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                out[rec["batch_id"]] = rec["status"]
        return out

    def pending(self) -> list:
        """Batches needing (re-)execution after a crash, with their
        journaled inputs.

        A pending record whose inputs npz is missing or unreadable is
        exactly the data loss the write-ahead journal exists to surface
        (begin() makes it unreachable short of external deletion), so it
        raises instead of being silently skipped."""
        todo = []
        for bid, status in sorted(self.scan().items()):
            if status == "done":
                continue
            path = os.path.join(self.dirpath, f"batch_{bid}_inputs.npz")
            try:
                inputs = dict(np.load(path))
            except (OSError, ValueError) as e:
                raise RuntimeError(
                    f"journal lists batch {bid} as {status!r} but its "
                    f"inputs file {path} is missing or corrupt: {e}") from e
            todo.append((bid, inputs))
        return todo


class CheckpointedRunner:
    """Wrap a batched encryptor with journaled, restartable execution.

    encrypt_fn(values, sk, share_words, err_words) -> dict with "ok";
    on ok=False the batch journals FAILED (callers may retry with fresh
    err seeds — the flags are astronomically rare, SURVEY.md §5)."""

    def __init__(self, journal: CheckpointJournal, encrypt_fn):
        self.journal = journal
        self.encrypt_fn = encrypt_fn

    def run(self, batch_id: int, values, sk_signed, share_words, err_words,
            on_output=None):
        self.journal.begin(batch_id, {
            "values": np.asarray(values),
            "share_words": np.asarray(share_words),
            "err_words": np.asarray(err_words),
        })
        out = self.encrypt_fn(values, sk_signed, share_words, err_words)
        ok = bool(np.asarray(out["ok"]).all())
        if not ok:
            self.journal.failed(batch_id, "ok flag false")
            return None
        if on_output is not None:
            on_output(batch_id, out)
        self.journal.done(batch_id)
        return out

    def resume(self, sk_signed, on_output=None):
        """Re-run every non-done journaled batch (identical bits)."""
        outs = {}
        for bid, inputs in self.journal.pending():
            outs[bid] = self.run(bid, inputs["values"], sk_signed,
                                 inputs["share_words"], inputs["err_words"],
                                 on_output)
        return outs
