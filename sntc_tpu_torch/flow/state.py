"""Crash-safe persistence for flow-operator state snapshots.

The snapshot-at-commit protocol (``flow/source.py``) publishes
one state blob per committed micro-batch, named by the batch's END
offset.  Each publish follows the ``save_model`` discipline:
write to a temp file, fsync, rename into place, fsync the directory —
so a crash (or an armed ``flow.state_snapshot`` kill) never leaves a
torn snapshot visible — and every blob seals its payload with a sha256
digest verified on load.  The store retains the last ``keep``
snapshots, which is what makes restore unambiguous: publishes happen
in commit order, exactly one publish can land between two commits, so
the retained snapshots always bracket the engine's committed offset
and ``load(committed_end)`` finds an exact match (or offset 0, the
fresh-state case).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
from typing import List, Optional

from sntc_tpu_torch.resilience import fault_point
from sntc_tpu_torch.resilience.storage import atomic_write_bytes

_MAGIC = b"SNTCFLOW1\n"
_NAME_RE = re.compile(r"state-(\d{12})\.bin$")


def verify_snapshot(path: str, end: Optional[int] = None) -> bytes:
    """Verify one snapshot blob's integrity (magic, header, payload
    length, sha256) and return the payload.  ``end`` additionally pins
    the header's offset against the expected one.  Shared by
    :meth:`FlowStateStore.load` and the ``sntc fsck`` doctor, so the
    two can never disagree about what 'corrupt' means."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        raise FlowStateCorruptError(
            f"flow-state snapshot {path}: bad magic"
        )
    head, _, payload = blob[len(_MAGIC):].partition(b"\n")
    try:
        header = json.loads(head.decode())
    except ValueError as e:
        raise FlowStateCorruptError(
            f"flow-state snapshot {path}: unreadable header ({e})"
        ) from e
    if end is not None and header.get("end") != int(end):
        raise FlowStateCorruptError(
            f"flow-state snapshot {path}: header names offset "
            f"{header.get('end')}, file names {end}"
        )
    if len(payload) != header.get("bytes"):
        raise FlowStateCorruptError(
            f"flow-state snapshot {path}: {len(payload)} payload "
            f"bytes, header says {header.get('bytes')} (torn write)"
        )
    got = hashlib.sha256(payload).hexdigest()
    if got != header.get("sha256"):
        raise FlowStateCorruptError(
            f"flow-state snapshot {path}: sha256 mismatch "
            f"(expected {str(header.get('sha256'))[:12]}…, got "
            f"{got[:12]}…)"
        )
    return payload


class FlowStateError(RuntimeError):
    """Operator state cannot be reconciled with the checkpoint's
    committed offset (missing snapshot for a nonzero offset)."""


class FlowStateCorruptError(FlowStateError):
    """A snapshot file fails its integrity check (bad magic, torn
    payload, sha256 mismatch) — names the offending file."""


class FlowStateStore:
    """One directory of ``state-<end>.bin`` snapshot blobs.  ``tenant``
    namespaces the ``flow.state_snapshot`` fault point and the
    ``storage.state`` write."""

    def __init__(self, path: str, keep: int = 2,
                 tenant: Optional[str] = None):
        if keep < 2:
            # fewer than 2 breaks the publish/commit bracketing: a
            # crash between snapshot publish and WAL commit must still
            # find the previous offset's snapshot on restart
            raise ValueError("FlowStateStore keep must be >= 2")
        self.path = path
        self.keep = int(keep)
        self.tenant = tenant
        os.makedirs(path, exist_ok=True)

    def _file(self, end: int) -> str:
        return os.path.join(self.path, f"state-{end:012d}.bin")

    def ends(self) -> List[int]:
        out = []
        for p in glob.glob(os.path.join(self.path, "state-*.bin")):
            m = _NAME_RE.search(p)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def publish(self, end: int, payload: bytes) -> str:
        """Atomically publish the snapshot for committed offset
        ``end`` (idempotent: a WAL replay republishes byte-equivalent
        state over the same name), then prune beyond ``keep``."""
        # kill point: the snapshot is serialized but nothing reached
        # disk (the ``flow.state_snapshot`` kill scenario)
        fault_point("flow.state_snapshot", tenant=self.tenant)
        header = json.dumps({
            "version": 1,
            "end": int(end),
            "bytes": len(payload),
            "sha256": hashlib.sha256(payload).hexdigest(),
        }).encode()
        final = self._file(end)
        # the physical write routes through the storage plane's atomic
        # publish: the ``storage.state`` fault_disk site injects
        # ENOSPC/torn-write there, and the failure POLICY is "fail" —
        # the error propagates into the engine's commit hook, whose
        # retry/quarantine machinery owns the consequence (a snapshot
        # that silently degraded would break restore bracketing)
        atomic_write_bytes(
            final, _MAGIC + header + b"\n" + payload,
            site="storage.state", tenant=self.tenant,
        )
        for old in self.ends()[:-self.keep]:
            try:
                os.unlink(self._file(old))
            except OSError:
                pass
        return final

    def load(self, end: int) -> Optional[bytes]:
        """The verified payload for offset ``end``, or None when no
        snapshot with that offset exists."""
        path = self._file(end)
        if not os.path.exists(path):
            return None
        return verify_snapshot(path, end)
