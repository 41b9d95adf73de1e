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
ledger the two packages are compared on).

The JAX predictor's device fault domain (OOM splits, compile poisoning,
host degradation) is not ported: a failure raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.device import resolve_device

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
    row buckets with floor N; 0 = off)."""

    # oversized frames keep at most this many chunk dispatches in flight
    CHUNK_WINDOW = 2

    def __init__(
        self,
        model: Transformer,
        chunk_rows: int = 131_072,
        bucket_rows: int = 0,
        device="cuda",
    ):
        self.model = model
        self.chunk_rows = int(chunk_rows)
        self.bucket_rows = int(bucket_rows)
        self.device = resolve_device(device)
        self.compile_events = 0  # distinct dispatched row shapes
        self.bucket_hits = 0  # dispatches that reused a seen shape
        self.padded_rows_total = 0  # wasted rows the buckets cost
        self._shapes_seen: set = set()

    def _record_shape(self, n_rows: int, padded: int = 0) -> None:
        if n_rows in self._shapes_seen:
            self.bucket_hits += 1
        else:
            self._shapes_seen.add(n_rows)
            self.compile_events += 1
        self.padded_rows_total += padded

    def _dispatch_one(self, frame: Frame) -> Callable[[], Frame]:
        """Dispatch ONE at-most-chunk_rows frame through the model's
        async transform, bucket-padded when armed; the returned finalize
        strips the pad tail via the validity mask."""
        from sntc_tpu_torch.kernels.assemble import pad_assemble

        model = self.model
        n = frame.num_rows
        target = bucket_rows_for(n, self.bucket_rows)
        if target == n or n == 0:
            self._record_shape(n)
            return model.transform_async(frame)
        self._record_shape(target, padded=target - n)
        valid = np.zeros(target, dtype=bool)
        valid[:n] = True
        inner = model.transform_async(
            pad_assemble(frame, target, valid, self.device)
        )

        def fin() -> Frame:
            out = inner()
            mask = to_host(out[VALID_COL])
            out = out.drop(VALID_COL)
            # a row-dropping stage may have filtered the padded frame:
            # the mask was filtered in lockstep and still marks exactly
            # the surviving real rows
            return out if mask.all() else out.filter(mask)

        return fin

    # -- public surface -----------------------------------------------------

    def predict_frame(self, frame: Frame) -> Frame:
        return self.predict_frame_async(frame)()

    def predict_frame_async(self, frame: Frame) -> Callable[[], Frame]:
        """Dispatch without blocking; returns a zero-arg finalize
        producing the output Frame.  Oversized frames dispatch
        chunk-by-chunk through a sliding window of ``CHUNK_WINDOW``
        outstanding chunks (chunk i+W dispatches once chunk i is copied
        back), with one finalize and one concat.  That finalize
        dispatches the later chunks, so it runs on the thread that
        launches work: the engine retires an oversized batch on its own
        thread."""
        if frame.num_rows <= self.chunk_rows:
            return self._dispatch_one(frame)
        chunks = [
            frame.slice(s, min(s + self.chunk_rows, frame.num_rows))
            for s in range(0, frame.num_rows, self.chunk_rows)
        ]
        fins = [self._dispatch_one(c) for c in chunks[: self.CHUNK_WINDOW]]

        def finalize() -> Frame:
            outs = []
            for i in range(len(chunks)):
                outs.append(fins[i]())
                fins[i] = None  # its device outputs may be freed
                nxt = i + self.CHUNK_WINDOW
                if nxt < len(chunks):  # chunk i+1 keeps the card busy
                    fins.append(self._dispatch_one(chunks[nxt]))
            return Frame.concat_all(outs)

        return finalize

    def fusion_stats(self) -> Optional[dict]:
        """The wrapped model's fusion evidence (``fuse.fusion_stats``),
        None for an unfused model."""
        from sntc_tpu_torch.fuse import fusion_stats

        return fusion_stats(self.model)
