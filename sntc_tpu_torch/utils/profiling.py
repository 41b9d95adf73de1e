"""Transfer ledger — host↔device copy counters of the serve path.

Counterpart of the ledger half of ``sntc_tpu/utils/profiling.py``
(``TransferLedger``, ``transfer_ledger``, ``ledger_scope``,
``active_ledgers``), counters only: no profiler trace and no metrics
mirror.

The whole-pipeline fusion compiler (``sntc_tpu_torch.fuse``) exists to
serve a micro-batch with one upload and one download; this ledger is the
evidence.  A copy is recorded where it is made:

* uploads — the padded block of ``kernels.assemble.pad_assemble``, the
  host columns that ``VectorAssembler`` stacks on the device, a fused
  segment's bind of a column still on the host, and a staged head's
  upload of host features;
* downloads — each finalize's copy of its packed outputs to the host;
* syncs — device→host reads made while a batch is dispatched that are
  not its outputs (the assembler's row-validity verdict in ``error`` and
  ``skip`` modes).

A copy to a CPU "device" is a no-op but is counted the same, so the CPU
tests hold the serve path to the same counts as the card.

Engines scope their own ledger around dispatch (:func:`ledger_scope`);
a dispatch site snapshots :func:`active_ledgers` and its finalize
records into the same ledgers, even on the delivery thread.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch


class TransferLedger:
    """Thread-safe host↔device copy counters.  ``dispatches`` counts
    fused-program calls (:meth:`record_uploads`); copies outside a fused
    dispatch are :meth:`record_movement`.  A ledger with a ``tenant``
    (a daemon tenant's engine) also mirrors its counts into the
    ``sntc_transfer_*{tenant=...}`` series; the others mirror nothing."""

    def __init__(self, tenant: Optional[str] = None):
        self._lock = threading.Lock()
        self.tenant = tenant
        self.dispatches = 0
        self.uploads = 0
        self.downloads = 0
        self.syncs = 0
        self.upload_bytes = 0
        self.download_bytes = 0

    def record_uploads(self, count: int, nbytes: int = 0) -> None:
        """One fused dispatch that uploaded ``count`` host arrays."""
        with self._lock:
            self.dispatches += 1
            self.uploads += int(count)
            self.upload_bytes += int(nbytes)
        if self.tenant is not None:
            self._mirror(dispatches=1, uploads=int(count),
                         upload_bytes=int(nbytes))

    def record_downloads(self, count: int, nbytes: int = 0) -> None:
        with self._lock:
            self.downloads += int(count)
            self.download_bytes += int(nbytes)
        if self.tenant is not None:
            self._mirror(downloads=int(count), download_bytes=int(nbytes))

    def _mirror(self, **counts: int) -> None:
        from sntc_tpu_torch.obs.metrics import inc

        for name, n in counts.items():
            if n:
                inc(f"sntc_transfer_{name}_total", n, tenant=self.tenant)

    def record_movement(self, uploads: int = 0, upload_bytes: int = 0,
                        downloads: int = 0, download_bytes: int = 0,
                        syncs: int = 0) -> None:
        """Copies made outside a fused dispatch: counted, not a
        dispatch."""
        with self._lock:
            self.uploads += int(uploads)
            self.upload_bytes += int(upload_bytes)
            self.downloads += int(downloads)
            self.download_bytes += int(download_bytes)
            self.syncs += int(syncs)
        if self.tenant is not None:
            self._mirror(uploads=int(uploads),
                         upload_bytes=int(upload_bytes),
                         downloads=int(downloads),
                         download_bytes=int(download_bytes))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "uploads": self.uploads,
                "downloads": self.downloads,
                "syncs": self.syncs,
                "upload_bytes": self.upload_bytes,
                "download_bytes": self.download_bytes,
            }


# the process-wide view every copy records into; scoped per-engine
# ledgers record beside it, never instead of it
_TRANSFER_LEDGER = TransferLedger()

# per-thread stack of scoped ledgers: pushed on the engine thread around
# dispatch; finalize closures carry their dispatch-time snapshot
_scoped = threading.local()


def transfer_ledger() -> TransferLedger:
    return _TRANSFER_LEDGER


@contextlib.contextmanager
def ledger_scope(ledger: TransferLedger):
    """Attribute the copies dispatched inside the block to ``ledger`` as
    well as to the process-wide one."""
    stack = getattr(_scoped, "stack", None)
    if stack is None:
        stack = _scoped.stack = []
    stack.append(ledger)
    try:
        yield ledger
    finally:
        stack.pop()


def active_ledgers() -> tuple:
    """The ledgers a copy made now records into: the process-wide one
    plus this thread's :func:`ledger_scope` stack."""
    stack = getattr(_scoped, "stack", None)
    if not stack:
        return (_TRANSFER_LEDGER,)
    return (_TRANSFER_LEDGER, *stack)


def record_movement(ledgers=None, **counts) -> None:
    """:meth:`TransferLedger.record_movement` into ``ledgers`` (default:
    :func:`active_ledgers` now)."""
    for led in ledgers if ledgers is not None else active_ledgers():
        led.record_movement(**counts)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """``a`` copied to ``device``, the copy recorded as one upload in the
    active ledgers."""
    record_movement(uploads=1, upload_bytes=a.nbytes)
    return torch.from_numpy(a).to(device)
