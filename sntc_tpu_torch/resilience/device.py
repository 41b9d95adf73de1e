"""Device fault domain: CUDA errors sorted into kinds, each answered on
the card.

Counterpart of ``sntc_tpu/resilience/device.py``.

* :func:`classify_device_error` maps an exception chain onto the JAX
  package's three kinds, ``device_oom`` / ``compile_error`` /
  ``device_lost``.  Only errors of a CUDA shape classify: an error
  tagged ``device_kind`` (the injected fault, :class:`DeviceExecError`),
  ``torch.cuda.OutOfMemoryError``, ``torch.AcceleratorError`` (matched
  by class name: older torch releases lack it), a ``RuntimeError`` whose
  message starts with ``CUDA error:`` or carries ``CUBLAS_STATUS_``, and
  the kernel binding's own :class:`~sntc_tpu_torch.kernels._build.
  KernelLaunchError` (by its ``cudaError`` code) and ``KernelBuildError``.
  A ``ValueError("cannot compile regex")`` from user code is None.

  ==================  ==================================================
  ``device_oom``      ``OutOfMemoryError``, "CUDA out of memory",
                      ``cudaErrorMemoryAllocation`` (2),
                      ``CUBLAS_STATUS_ALLOC_FAILED``
  ``compile_error``   the kernel library's build errors,
                      ``cudaErrorNoKernelImageForDevice`` (209),
                      ``cudaErrorInvalidKernelImage`` (200),
                      ``cudaErrorInvalidPtx`` (218)
  ``device_lost``     the sticky errors: illegal address (700),
                      device-side assert (710), launch failure (719),
                      unknown (999); ``cudaErrorDevicesUnavailable`` (46)
  ==================  ==================================================

* :class:`DeviceFaultDomain` holds the response state.  An OOM splits
  the micro-batch in half and retries each half on the card
  (``BatchPredictor``), stepping the shape-bucket floor down.
  ``compile_error`` and ``device_lost`` are platform faults: they never
  strike, quarantine or score a breaker for the batch, which the engine
  re-dispatches on the card.  After ``degrade_after`` device faults with
  no clean batch between them the domain is DEVICE_FAILED: every later
  dispatch raises :class:`DeviceExecError`, the query stops with the
  batch's intent in the WAL (a restart replays it), and a
  ``device_failed`` event marks the model UNHEALTHY.

The JAX domain's ``HOST_DEGRADED`` state, its host fallback dispatch,
per-signature poisoning, recovery probe and compile watchdog
(``--compile-budget-s``) are not ported: nothing of the port falls back
to the CPU, and its kernels are built once, before the first batch, not
compiled per signature.
"""

from __future__ import annotations

import re
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from sntc_tpu_torch.kernels._build import KernelBuildError, KernelLaunchError
from sntc_tpu_torch.resilience.policy import emit_event

DEVICE_OK = "DEVICE_OK"
DEVICE_FAILED = "DEVICE_FAILED"

#: the ``cudaError_t`` codes that classify, by kind
CUDA_ERROR_KINDS = {
    2: "device_oom",
    200: "compile_error",
    209: "compile_error",
    218: "compile_error",
    46: "device_lost",
    700: "device_lost",
    710: "device_lost",
    719: "device_lost",
    999: "device_lost",
}

# cudaGetErrorString's text (and the enum names) of the codes above, in
# PyTorch's "CUDA error: <text>" lines
_OOM_RE = re.compile(
    r"CUDA out of memory|CUDA error: out of memory"
    r"|cudaErrorMemoryAllocation|CUBLAS_STATUS_ALLOC_FAILED",
    re.IGNORECASE,
)
_COMPILE_RE = re.compile(
    r"no kernel image is available|device kernel image is invalid"
    r"|PTX JIT compilation failed|cudaErrorNoKernelImageForDevice"
    r"|cudaErrorInvalidKernelImage|cudaErrorInvalidPtx",
    re.IGNORECASE,
)
_LOST_RE = re.compile(
    r"illegal memory access|device-side assert triggered"
    r"|unspecified launch failure|CUDA error: unknown error"
    r"|busy or unavailable|cudaErrorIllegalAddress|cudaErrorAssert"
    r"|cudaErrorLaunchFailure|cudaErrorUnknown|cudaErrorDevicesUnavailable",
    re.IGNORECASE,
)


def _cuda_shaped(exc: BaseException) -> bool:
    """Only CUDA-shaped errors may classify by their message."""
    for klass in type(exc).__mro__:
        if klass.__name__ in ("OutOfMemoryError", "AcceleratorError"):
            return True
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        return msg.startswith("CUDA error:") or "CUBLAS_STATUS_" in msg
    return False


def _kind_of(exc: BaseException) -> Optional[str]:
    kind = getattr(exc, "device_kind", None)
    if kind is not None:
        return kind
    if isinstance(exc, KernelLaunchError):
        return CUDA_ERROR_KINDS.get(exc.cuda_error)
    if isinstance(exc, KernelBuildError):
        return "compile_error"
    if not _cuda_shaped(exc):
        return None
    msg = str(exc)
    if _OOM_RE.search(msg):
        return "device_oom"
    if _COMPILE_RE.search(msg):
        return "compile_error"
    if _LOST_RE.search(msg):
        return "device_lost"
    if any(k.__name__ == "OutOfMemoryError" for k in type(exc).__mro__):
        return "device_oom"
    return None


def classify_device_error(exc: Optional[BaseException]) -> Optional[str]:
    """The device kind an exception chain carries, or None for anything
    that is not a CUDA failure.  Walks ``__cause__``/``__context__``
    (at most 8 links), so a wrapped finalize error still classifies."""
    seen = 0
    while exc is not None and seen < 8:
        kind = _kind_of(exc)
        if kind is not None:
            return kind
        exc = exc.__cause__ or exc.__context__
        seen += 1
    return None


class DeviceExecError(RuntimeError):
    """A device failure with its context: which batch, which fused
    segment, which input signature.  ``device_kind`` makes it classify
    without matching its message."""

    def __init__(
        self,
        message: str,
        *,
        kind: Optional[str] = None,
        batch_id: Optional[int] = None,
        segment: Optional[int] = None,
        signature: Optional[str] = None,
    ):
        super().__init__(message)
        self.device_kind = kind
        self.batch_id = batch_id
        self.segment = segment
        self.signature = signature


def annotate_batch(exc: BaseException, batch_id: int) -> BaseException:
    """Thread the batch id through an error without changing its type:
    a ``batch_id`` attribute and a note."""
    if getattr(exc, "batch_id", None) is None:
        try:
            exc.batch_id = batch_id
        except Exception:
            pass
        try:
            exc.add_note(
                f"[sntc] while finalizing/delivering batch {batch_id}"
            )
        except Exception:
            pass
    return exc


def release_frames(exc: Optional[BaseException]) -> None:
    """Clear the locals of the finished frames that an exception chain's
    tracebacks hold.  A failed dispatch's frames hold its device tensors
    (the padded block, the leaf statistics); an OOM split must not
    allocate its halves on top of them."""
    seen = 0
    while exc is not None and seen < 8:
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__
        seen += 1


@dataclass
class DevicePolicy:
    """The domain's tuning: ``oom_split_depth`` bounds the halvings of
    one dispatch; ``bucket_floor_min`` is where the OOM responder stops
    stepping the bucket floor down, and ``floor_restore_after`` clean
    dispatches put the floor back; ``degrade_after`` device faults with
    no clean batch between them fail the domain."""

    oom_split_depth: int = 4
    bucket_floor_min: int = 1
    floor_restore_after: int = 64
    degrade_after: int = 3
    journal_keep: int = 256

    def __post_init__(self):
        self.oom_split_depth = max(1, int(self.oom_split_depth))
        self.bucket_floor_min = max(1, int(self.bucket_floor_min))
        self.degrade_after = max(1, int(self.degrade_after))


def _metrics():
    from sntc_tpu_torch.obs import metrics

    return metrics


class DeviceFaultDomain:
    """The response state of one card (see the module docs).
    Thread-safe: faults are noted from the engine thread and successes
    from the delivery thread."""

    def __init__(self, policy: Optional[DevicePolicy] = None):
        self.policy = policy or DevicePolicy()
        self._lock = threading.Lock()
        self._state = DEVICE_OK
        self._failed_reason: Optional[str] = None
        self._consecutive = 0
        self.faults: Dict[str, int] = {}
        self.oom_splits = 0
        self.bucket_floor_steps = 0
        self.journal: List[dict] = []
        self._gauge(0)

    @property
    def state(self) -> str:
        return self._state

    @property
    def failed(self) -> bool:
        return self._state == DEVICE_FAILED

    def _gauge(self, value: int) -> None:
        try:
            _metrics().set_gauge("sntc_device_state", value)
        except Exception:
            pass

    def _journal(self, record: dict) -> None:
        record = dict(record, ts=time.time())
        with self._lock:
            self.journal.append(record)
            if len(self.journal) > self.policy.journal_keep:
                del self.journal[: -self.policy.journal_keep]

    def note_fault(self, kind: str, *, site: str, **context: Any) -> None:
        """One device failure: count it, emit ``device_fault`` (never a
        strike event), and fail the domain at the ``degrade_after``-th
        fault in a row."""
        with self._lock:
            self.faults[kind] = self.faults.get(kind, 0) + 1
            self._consecutive += 1
            consecutive = self._consecutive
        try:
            _metrics().inc("sntc_device_faults_total", kind=kind, site=site)
        except Exception:
            pass
        emit_event(event="device_fault", component="model", site=site,
                   kind=kind, consecutive=consecutive, **context)
        if consecutive >= self.policy.degrade_after:
            self._fail(f"{consecutive} device faults in a row "
                       f"(last: {kind} at {site})")

    def _fail(self, reason: str) -> None:
        with self._lock:
            if self._state == DEVICE_FAILED:
                return
            self._state = DEVICE_FAILED
            self._failed_reason = reason
        self._gauge(1)
        self._journal({"decision": "device_failed", "reason": reason})
        emit_event(event="device_failed", component="model", reason=reason)

    def check(self) -> None:
        """Raise :class:`DeviceExecError` once the domain has failed:
        the call every dispatch makes first."""
        if self._state == DEVICE_FAILED:
            raise DeviceExecError(
                f"the CUDA device failed ({self._failed_reason}); the "
                "query stops with its batch in the WAL for a restart",
                kind="device_lost",
            )

    def note_success(self) -> None:
        """A batch came back from the card: the run of faults ends."""
        if self._consecutive:
            with self._lock:
                self._consecutive = 0

    def note_oom_split(self, *, rows: int, depth: int, bucket_floor: int,
                       error: str = "") -> None:
        with self._lock:
            self.oom_splits += 1
        try:
            _metrics().inc("sntc_device_oom_splits_total")
        except Exception:
            pass
        self._journal({"decision": "device_oom_split", "rows": rows,
                       "depth": depth, "bucket_floor": bucket_floor})
        emit_event(event="device_oom_split", component="model",
                   site="device.dispatch", rows=rows, depth=depth,
                   error=error)

    def note_mesh_resize(self, *, old: int, new: int, axis: str,
                         site: str) -> None:
        """A mesh participant dropped out and the collective layer
        resized: the data axis shrank ``old`` → ``new`` and the fit goes
        on on the survivors.  Journaled, and counted as a
        ``device_lost`` fault, but not part of the failure streak: the
        resize is already the response."""
        with self._lock:
            self.faults["device_lost"] = self.faults.get("device_lost", 0) + 1
        try:
            _metrics().inc("sntc_device_faults_total", kind="device_lost",
                           site=site)
        except Exception:
            pass
        self._journal({"decision": "mesh_resize", "axis": axis,
                       "from": old, "to": new, "site": site})
        emit_event(event="mesh_resize", component="model", site=site,
                   axis=axis, old=old, new=new)

    def note_bucket_floor(self, old: int, new: int) -> None:
        with self._lock:
            self.bucket_floor_steps += 1
        self._journal({"decision": "bucket_floor_down", "from": old,
                       "to": new})

    def note_bucket_restore(self, old: int, new: int) -> None:
        self._journal({"decision": "bucket_floor_restored", "from": old,
                       "to": new})

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "failed_reason": self._failed_reason,
                "consecutive_faults": self._consecutive,
                "faults": dict(self.faults),
                "oom_splits": self.oom_splits,
                "bucket_floor_steps": self.bucket_floor_steps,
                "journal": list(self.journal[-8:]),
            }
