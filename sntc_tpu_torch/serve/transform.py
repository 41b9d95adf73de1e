"""BatchPredictor — batch inference with shape buckets.

Counterpart of ``sntc_tpu/serve/transform.py``: a fitted model/pipeline
served over Frames, chunked to bound device memory: at most
``CHUNK_WINDOW`` chunks of ``chunk_rows`` rows are in flight at once.

A fused pipeline (``sntc_tpu_torch.fuse``) is served the same way; its
segments bind the padded columns where ``pad_assemble`` left them, on
the device, and :meth:`BatchPredictor.fusion_stats` reports them.

**Shape buckets** (``bucket_rows > 0``): each batch is padded up to the
next power-of-two row count (no lower than ``bucket_rows``) by repeating
the last row, a row-validity mask (``VALID_COL``) rides through the
transform, and finalize drops the pad tail — predictions over the padded
batch equal the unpadded ones.  The padding runs through the
``pad_assemble`` kernel on the predictor's device.  ``compile_events``
counts the distinct dispatched row shapes, as the JAX package's
predictor does (there each one is an XLA compile; here it is the shape
ledger the two packages are compared on).  The ledger is mirrored into
``sntc_predict_compile_events_total``, ``..._bucket_hits_total`` and
``..._padded_rows_total``.

**Row admission** (``row_valid``, the salvage mask of a
``data.schema.SchemaContract``; True = admitted): excised rows ride
inside the dispatched frame, already overwritten by the contract with a
donor row, and are dropped at finalize through the same ``VALID_COL``
mask as bucket padding.  A batch is dispatched plain only when it fills
its bucket and every row is admitted; any other batch goes through
``pad_assemble(frame, target, valid)``, a full one too (a zero-row pad),
so salvage never changes a dispatched shape and ``compile_events`` stays
flat.

**Device fault domain** (``device_domain``, a
``resilience.device.DeviceFaultDomain``): a CUDA error at a dispatch is
classified and answered on the card, as in the JAX predictor
(``_dispatch_one``, ``_respond_device``, ``_step_bucket_floor``).  An
OOM halves the batch and dispatches each half again, recursively, down
to the bucket floor and at most ``oom_split_depth`` deep; the halves'
outputs are concatenated in order (``pad_assemble`` and the serve
kernels are bitwise per row, so the batch's output is the unsplit
one's), and the bucket floor steps down once per top-level dispatch,
back up after ``floor_restore_after`` clean dispatches.  The failed
attempt's frames are cleared first, so its device tensors are freed
before the halves allocate.  Any other kind, or an OOM that cannot split
further, is noted with the domain and raised for the engine to
re-dispatch the batch; once the domain has failed, every dispatch raises
``DeviceExecError``.  Nothing falls back to the host: the JAX
predictor's host path and shape poisoning are not ported.  The fault
sites ``predict.compile`` (a fresh padded shape) and
``device.dispatch`` (every dispatch) fire only with a domain.

:meth:`BatchPredictor.swap_model` replaces the served model between
micro-batches (the lifecycle's hot swap), keeping the shape ledger.

Padding runs in the span ``predict.bucket`` (rows, bucket;
``obs.trace``), as in the JAX predictor.

``predict_frame_async``'s finalize is once-only (a failure is cached
too), so a sink retry re-reads the batch instead of materializing it
again; with a domain its first clean return notes a success, which ends
a run of device faults.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.obs.metrics import inc
from sntc_tpu_torch.obs.trace import span
from sntc_tpu_torch.resilience.device import (
    DeviceExecError,
    classify_device_error,
    release_frames,
)
from sntc_tpu_torch.resilience.faults import fault_point

# row-validity mask column threaded through bucketed transforms: True for
# real rows, False for bucket-padding rows.  Row-dropping stages
# (handleInvalid='skip') filter it in lockstep with every other column.
VALID_COL = "__sntc_row_valid"


def bucket_rows_for(n_rows: int, floor: int) -> int:
    """The padded row count for an ``n_rows`` batch: the next power of
    two, but never below ``floor``.  ``floor <= 0`` disables bucketing."""
    if floor <= 0 or n_rows <= 0:
        return n_rows
    b = 1 << max(0, int(floor) - 1).bit_length()  # next pow2 >= floor
    while b < n_rows:
        b <<= 1
    return b


class BatchPredictor:
    """Wrap a fitted model/pipeline for batch inference on ``device``.

    ``bucket_rows=N`` arms shape-bucketed dispatch (pad to power-of-two
    row buckets with floor N; 0 = off); ``device_domain`` arms the device
    fault domain (see the module docs)."""

    # oversized frames keep at most this many chunk dispatches in flight
    CHUNK_WINDOW = 2

    def __init__(
        self,
        model: Transformer,
        chunk_rows: int = 131_072,
        bucket_rows: int = 0,
        device="cuda",
        device_domain=None,
    ):
        self.model = model
        self.chunk_rows = int(chunk_rows)
        self.bucket_rows = int(bucket_rows)
        self.device = resolve_device(device)
        self.compile_events = 0  # distinct dispatched row shapes
        self.bucket_hits = 0  # dispatches that reused a seen shape
        self.padded_rows_total = 0  # wasted rows the buckets cost
        self._shapes_seen: set = set()
        self.device_domain = device_domain
        # the OOM responder's floor step-down is undone after
        # floor_restore_after clean dispatches
        self._cold_bucket_rows = self.bucket_rows
        self._clean_streak = 0
        if device_domain is not None:
            from sntc_tpu_torch.fuse import attach_device_domain

            attach_device_domain(model, device_domain)

    def swap_model(self, model: Transformer) -> Transformer:
        """Hot-swap the wrapped model IN PLACE, keeping the shape ledger
        and the bucket settings (the lifecycle's hot swap); returns the
        replaced model.  Dispatches already made finalize against the
        OLD model (their closures bound it); the engine calls this only
        between micro-batches.  The device domain, if any, is handed to
        the new model's fused segments.  The JAX predictor also clears
        its per-signature poisons here; the port poisons nothing, so
        there is nothing to clear."""
        old, self.model = self.model, model
        if self.device_domain is not None:
            from sntc_tpu_torch.fuse import attach_device_domain

            attach_device_domain(model, self.device_domain)
        return old

    def _record_shape(self, n_rows: int, padded: int = 0) -> None:
        fresh = n_rows not in self._shapes_seen
        if fresh:
            self._shapes_seen.add(n_rows)
            self.compile_events += 1
        else:
            self.bucket_hits += 1
        self.padded_rows_total += padded
        # the sntc_predict_* series mirror the attributes, which stay
        # the views the daemon's recompiles_after_warmup() reads
        inc("sntc_predict_compile_events_total" if fresh
            else "sntc_predict_bucket_hits_total")
        if padded:
            inc("sntc_predict_padded_rows_total", padded)

    @staticmethod
    def _plain(n: int, target: int, row_valid) -> bool:
        """A batch dispatches unpadded only when it fills its bucket and
        every row is admitted."""
        return (target == n or n == 0) and (
            row_valid is None or bool(np.all(row_valid)))

    def _launch(self, frame: Frame, n: int, target: int,
                row_valid=None) -> Callable[[], Frame]:
        """Dispatch ONE frame through the model's async transform; a
        batch that is not plain goes through ``pad_assemble`` to
        ``target`` rows with its validity mask, and the returned
        finalize keeps the rows the mask marks."""
        from sntc_tpu_torch.kernels.assemble import pad_assemble

        model = self.model
        if self._plain(n, target, row_valid):
            self._record_shape(n)
            return model.transform_async(frame)
        self._record_shape(target, padded=target - n)
        with span("predict.bucket", rows=n, bucket=target):
            valid = np.zeros(target, dtype=bool)
            valid[:n] = True if row_valid is None else row_valid
            padded = pad_assemble(frame, target, valid, self.device)
        inner = model.transform_async(padded)

        def fin() -> Frame:
            out = inner()
            mask = to_host(out[VALID_COL])
            out = out.drop(VALID_COL)
            # a row-dropping stage may have filtered the padded frame:
            # the mask was filtered in lockstep and still marks exactly
            # the surviving real rows
            return out if mask.all() else out.filter(mask)

        return fin

    def _dispatch_one(self, frame: Frame, row_valid=None,
                      _oom_depth: int = 0) -> Callable[[], Frame]:
        """Dispatch one at-most-chunk_rows frame with its admission mask;
        with a device domain, through its fault sites and response (see
        the module docs)."""
        n = frame.num_rows
        target = bucket_rows_for(n, self.bucket_rows)
        dom = self.device_domain
        if dom is None:
            return self._launch(frame, n, target, row_valid)
        dom.check()
        shape = n if self._plain(n, target, row_valid) else target
        try:
            if n and shape not in self._shapes_seen:
                fault_point("predict.compile")
            fault_point("device.dispatch")
            fin = self._launch(frame, n, target, row_valid)
        except Exception as e:
            kind = classify_device_error(e)
            if kind is None:
                raise
            exc = e
        else:
            if self.bucket_rows != self._cold_bucket_rows:
                # the OOM pressure passed: small batches get their
                # shared buckets back
                self._clean_streak += 1
                if self._clean_streak >= dom.policy.floor_restore_after:
                    dom.note_bucket_restore(self.bucket_rows,
                                            self._cold_bucket_rows)
                    self.bucket_rows = self._cold_bucket_rows
                    self._clean_streak = 0
            return fin
        # outside the except block: the failed attempt's device tensors
        # go with its frames before anything is dispatched again
        release_frames(exc)
        return self._respond_device(kind, exc, frame, row_valid, _oom_depth)

    def _respond_device(self, kind: str, exc: BaseException, frame: Frame,
                        row_valid, depth: int) -> Callable[[], Frame]:
        """The response to one classified device failure."""
        dom = self.device_domain
        n = frame.num_rows
        if kind == "device_oom":
            self._clean_streak = 0
            if n > max(1, self.bucket_rows) \
                    and depth < dom.policy.oom_split_depth:
                # halve and retry on the card at the smaller shape; the
                # floor steps down once per top-level dispatch
                dom.note_oom_split(rows=n, depth=depth,
                                   bucket_floor=self.bucket_rows,
                                   error=repr(exc)[:500])
                if depth == 0:
                    self._step_bucket_floor()
                mid = (n + 1) // 2
                lmask = None if row_valid is None else row_valid[:mid]
                rmask = None if row_valid is None else row_valid[mid:]
                left = self._dispatch_one(frame.slice(0, mid), lmask,
                                          depth + 1)
                right = self._dispatch_one(frame.slice(mid, n), rmask,
                                           depth + 1)
                return lambda: Frame.concat_all([left(), right()])
            dom.note_fault(kind, site="device.dispatch", rows=n)
        else:
            dom.note_fault(kind, site="predict.compile"
                           if kind == "compile_error" else "device.dispatch")
        # counted here: the engine must not count it again
        try:
            exc._sntc_device_counted = True
        except Exception:
            pass
        if dom.failed:
            try:
                dom.check()
            except DeviceExecError as failed:
                raise failed from exc
        raise exc

    def _step_bucket_floor(self) -> None:
        """OOM pressure: halve the shape-bucket floor (never below the
        policy's minimum)."""
        dom = self.device_domain
        if self.bucket_rows <= dom.policy.bucket_floor_min:
            return
        new = max(dom.policy.bucket_floor_min, self.bucket_rows // 2)
        if new != self.bucket_rows:
            dom.note_bucket_floor(self.bucket_rows, new)
            self.bucket_rows = new

    def _memo(self, fin: Callable[[], Frame]) -> Callable[[], Frame]:
        """Once-only finalize: a retry re-reads the first outcome (a
        failure included) instead of materializing again."""
        cell: List = []
        dom = self.device_domain

        def wrapper() -> Frame:
            if not cell:
                try:
                    cell.append((True, fin()))
                except BaseException as e:
                    cell.append((False, e))
                else:
                    if dom is not None:
                        dom.note_success()
            ok, val = cell[0]
            if not ok:
                raise val
            return val

        return wrapper

    # -- public surface -----------------------------------------------------

    def predict_frame(self, frame: Frame, row_valid=None) -> Frame:
        return self.predict_frame_async(frame, row_valid=row_valid)()

    def predict_frame_async(self, frame: Frame,
                            row_valid=None) -> Callable[[], Frame]:
        """Dispatch without blocking; returns a zero-arg, once-only
        finalize producing the output Frame.  ``row_valid`` (the
        admission mask, True = admitted) rides the dispatch and its rows
        are dropped at finalize.  Oversized frames dispatch
        chunk-by-chunk through a sliding window of ``CHUNK_WINDOW``
        outstanding chunks (chunk i+W dispatches once chunk i is copied
        back), with one finalize and one concat.  That finalize
        dispatches the later chunks, so it runs on the thread that
        launches work: the engine retires an oversized batch on its own
        thread."""
        if row_valid is not None:
            row_valid = np.asarray(row_valid, dtype=bool)
            if row_valid.shape != (frame.num_rows,):
                raise ValueError(
                    f"row_valid has shape {row_valid.shape}, expected "
                    f"({frame.num_rows},)")
        if frame.num_rows <= self.chunk_rows:
            return self._memo(self._dispatch_one(frame, row_valid))
        starts = range(0, frame.num_rows, self.chunk_rows)
        chunks = [
            frame.slice(s, min(s + self.chunk_rows, frame.num_rows))
            for s in starts
        ]
        masks = [None if row_valid is None
                 else row_valid[s:s + self.chunk_rows] for s in starts]
        fins = [self._dispatch_one(c, m)
                for c, m in zip(chunks[: self.CHUNK_WINDOW],
                                masks[: self.CHUNK_WINDOW])]

        def finalize() -> Frame:
            outs = []
            for i in range(len(chunks)):
                outs.append(fins[i]())
                fins[i] = None  # its device outputs may be freed
                nxt = i + self.CHUNK_WINDOW
                if nxt < len(chunks):  # chunk i+1 keeps the card busy
                    fins.append(self._dispatch_one(chunks[nxt], masks[nxt]))
            return Frame.concat_all(outs)

        return self._memo(finalize)

    def fusion_stats(self) -> Optional[dict]:
        """The wrapped model's fusion evidence (``fuse.fusion_stats``),
        None for an unfused model."""
        from sntc_tpu_torch.fuse import fusion_stats

        return fusion_stats(self.model)
