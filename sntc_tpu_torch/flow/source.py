"""Raw-capture stream source: capture files → keyed windows → feature
rows, with snapshot-at-commit crash safety.

:class:`FlowCaptureSource` plugs the stateful
:class:`~sntc_tpu_torch.flow.engine.FlowFeatureEngine` into the micro-batch
engine as an ordinary :class:`~sntc_tpu_torch.serve.streaming.DirStreamSource`:
the offset model is the capture-file count (exactly the
``NetFlowDirSource``/``PcapDirSource`` model), ``get_batch`` parses the
range's raw bytes (through the ``source.parse`` fault/corruption site),
feeds the records into the window operator, and returns the batch of
COMPLETED windows' CICIDS2017 feature rows — which then flow through
the unchanged serve path (admission → bucketed/fused predict → sink).

**The state contract.**  A stateful source must replay exactly: the
engine's WAL recovery re-issues uncommitted intents with their logged
ranges, so operator state must rewind to "as of the last commit".
Three hooks implement snapshot-at-commit:

* ``get_batch`` stages a post-consume state serialization keyed by the
  range's end offset (staging at READ time matters: in pipelined mode
  later batches may consume before this one commits);
* ``on_batch_committed`` (called by ``StreamingQuery`` BEFORE the WAL
  commit record is written) publishes the staged snapshot through
  :class:`~sntc_tpu_torch.flow.state.FlowStateStore` — publish-then-commit
  means the retained snapshots always bracket the committed offset;
* ``on_restore`` (called at query construction with the recovered
  committed end) loads the exact-offset snapshot and rewinds the
  operator, after which WAL replay reconverges **bitwise** (emission
  is a pure function of state + consumed range).

Consumption is strictly ordered (ranges advance monotonically; a
same-range re-read — the engine's read-retry path — returns the
memoized batch without re-consuming).  A range skipped by load
shedding is allowed through: those packets are lost by the journaled
shed decision, not silently.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.flow.engine import (
    FlowFeatureEngine,
    NetFlowMeter,
    PcapFlowMeter,
)
from sntc_tpu_torch.flow.state import FlowStateError, FlowStateStore
from sntc_tpu_torch.obs.metrics import inc, set_gauge
from sntc_tpu_torch.obs.trace import span
from sntc_tpu_torch.resilience import fault_point
from sntc_tpu_torch.serve.netflow_source import (
    _CaptureDirSource,
    decode_pcap_packets,
)

#: capture format → default filename pattern
FORMATS = {"pcap": "*.pcap", "netflow": "*.nf5"}

_PKTS = "__records__"


class FlowCaptureSource(_CaptureDirSource):
    """Directory of capture files served as completed-window feature
    batches (module docstring has the protocol).  Parsing is stateless
    and rides the inherited listing-cache / parallel-read / prefetch /
    ``source.parse`` fault machinery (``_CaptureDirSource``); only
    consumption is ordered and stateful."""

    def __init__(
        self,
        path: str,
        format: str = "pcap",
        pattern: Optional[str] = None,
        flow_timeout: float = 120.0,
        activity_timeout: float = 5.0,
        allowed_lateness: float = 5.0,
        max_state_packets: int = 500_000,
        state_dir: Optional[str] = None,
        tenant: Optional[str] = None,
        **kwargs,
    ):
        if format not in FORMATS:
            raise ValueError(
                f"unknown capture format {format!r}; expected one of "
                f"{sorted(FORMATS)}"
            )
        # the source's meters carry the tenant from construction
        kwargs.setdefault("tenant", tenant)
        super().__init__(path, pattern or FORMATS[format], **kwargs)
        self.format = format
        meter = (
            PcapFlowMeter(flow_timeout=flow_timeout,
                          activity_timeout=activity_timeout)
            if format == "pcap"
            else NetFlowMeter(flow_timeout=flow_timeout)
        )
        self.engine = FlowFeatureEngine(
            meter,
            allowed_lateness=allowed_lateness,
            max_state_packets=max_state_packets,
            tenant=tenant,
        )
        self._mlabels = {} if tenant is None else {"tenant": tenant}
        self.store = (
            FlowStateStore(state_dir, tenant=tenant)
            if state_dir is not None else None
        )
        self._consumed_end = 0
        self._memo: Optional[Tuple[Tuple[int, int], Frame]] = None
        # range whose records are folded into state but whose emission
        # has not completed yet: a failure between consume and the memo
        # (an eviction-pass fault, a transient in the meter emit) makes
        # the engine's retry re-enter — it must resume at the POLL,
        # never re-consume
        self._pending: Optional[Tuple[int, int]] = None
        self._staged_state: Dict[int, bytes] = {}
        # end offset of the last consumed-but-unpublished range: its
        # state serializes lazily — at commit when nothing was consumed
        # after it, or just-in-time before the NEXT consume overwrites
        # it (the pipelined read-ahead case)
        self._snapshot_due: Optional[int] = None
        self.snapshots_published = 0

    # -- parse (stateless; runs on reader/prefetch threads) ------------------

    def _decode_file(self, data: bytes) -> Frame:
        """Raw capture bytes → a packets Frame (one 2-D record-matrix
        column): decode policy shared with the per-file serving
        sources, metering deferred to the stateful engine."""
        if self.format == "netflow":
            from sntc_tpu_torch.native import parse_stream

            return Frame({_PKTS: parse_stream(data)})
        return Frame({_PKTS: decode_pcap_packets(data)})

    # -- ordered stateful consumption ---------------------------------------

    def get_batch(self, start: int, end: int) -> Frame:
        if self._memo is not None and self._memo[0] == (start, end):
            # engine read-retry / deferred re-dispatch of the SAME
            # range: the records are already in state — hand back the
            # memoized emission instead of double-consuming
            return self._memo[1]
        if self._pending == (start, end):
            # the range's records are already folded in; the first
            # pass died between consume and the memo (eviction-pass
            # fault, meter transient): resume at the poll — never
            # re-consume.  poll() itself mutates nothing until the
            # meter emit succeeds, so re-polling is idempotent.
            emitted = self.engine.poll()
        else:
            if start < self._consumed_end:
                raise ValueError(
                    f"flow source consumed through offset "
                    f"{self._consumed_end} but was asked to re-read "
                    f"[{start}, {end}): stateful windows replay only "
                    "through the checkpoint's snapshot-at-commit "
                    "protocol"
                )
            frame = super().get_batch(start, end)
            records = np.asarray(frame[_PKTS])
            if self.store is not None and self._snapshot_due is not None:
                # the previous consumed range is still uncommitted
                # (pipelined read-ahead): capture its state before
                # this consume overwrites it; the serial path never
                # pays this — its snapshot serializes at commit from
                # the live state
                self._staged_state[self._snapshot_due] = (
                    self.engine.snapshot()
                )
                self._snapshot_due = None
            with span("flow.consume", records=int(records.shape[0])):
                self.engine.consume(records)
                # consumed, not yet emitted: a failure from here to
                # the memo re-enters through the _pending branch above
                self._pending = (start, end)
                emitted = self.engine.poll()
        # emission bookkeeping lands BEFORE the fault point: a raising
        # flow.emit fault — or the engine's read retry after any
        # later failure — re-enters through the memo and can never
        # double-consume; a KILL here still loses only in-memory
        # state (nothing durable yet)
        self._consumed_end = end
        if self.store is not None:
            self._snapshot_due = end
        self._memo = ((start, end), emitted)
        self._pending = None
        # kill point: windows emitted in memory, nothing durable yet
        # (the ``flow.emit`` kill scenario)
        fault_point("flow.emit", tenant=self.tenant)
        return emitted

    # -- StreamingQuery state hooks -----------------------------------------

    def on_restore(self, committed_end: int) -> None:
        """Rewind operator state to the snapshot matching the WAL's
        committed end offset (query construction calls this before any
        replay)."""
        self._staged_state.clear()
        self._memo = None
        self._pending = None
        self._snapshot_due = None
        if self.store is None:
            if committed_end:
                raise FlowStateError(
                    f"checkpoint committed through offset "
                    f"{committed_end} but this FlowCaptureSource has "
                    "no state_dir: the operator state of the consumed "
                    "captures is unrecoverable (arm state_dir, or "
                    "start a fresh checkpoint)"
                )
            return
        payload = self.store.load(committed_end)
        if payload is None:
            if committed_end == 0:
                self._consumed_end = 0
                return
            raise FlowStateError(
                f"no flow-state snapshot for committed offset "
                f"{committed_end} under {self.store.path!r} (have "
                f"{self.store.ends()}): state and WAL have diverged"
            )
        self.engine.restore(payload)
        self._consumed_end = committed_end

    def on_batch_committed(self, batch_id: int, intent: dict) -> None:
        """Publish the committed batch's staged snapshot (called by
        the engine BEFORE the WAL commit record lands — the retained
        snapshots then always bracket the committed offset).  A range
        that quarantined mid-emission is first EXCISED from state."""
        end = int(intent["end"])
        if self._pending is not None and self._pending[1] <= end:
            # the batch is being committed with its records folded in
            # but its windows never emitted — a read-stage quarantine
            # after persistent poll failures.  Roll its consume back:
            # the dead letter owns the poison batch, keyed state must
            # not keep its packets (they would cascade the same
            # failing eviction set into every later batch's poll, and
            # the published snapshot must really be "state untouched
            # by the quarantined batch").
            self.engine.rollback_last_consume()
            self._pending = None
        if self.store is None:
            return
        payload = self._staged_state.pop(end, None)
        for stale in [k for k in self._staged_state if k <= end]:
            del self._staged_state[stale]
        if payload is None and self._snapshot_due == end:
            # nothing was consumed after this range (the serial-engine
            # common case): the live state IS its post-consume state
            payload = self.engine.snapshot()
        if self._snapshot_due is not None and self._snapshot_due <= end:
            self._snapshot_due = None
        if payload is None:
            # a batch that never completed get_batch (read-stage
            # quarantine) commits with state untouched by it; the
            # quarantine path only runs with nothing else in flight,
            # so the live state IS the committed state
            payload = self.engine.snapshot()
        with span("flow.snapshot", batch=batch_id):
            self.store.publish(end, payload)
        self.snapshots_published += 1
        inc("sntc_flow_snapshots_total", **self._mlabels)
        set_gauge("sntc_flow_state_bytes", len(payload), **self._mlabels)

    # -- operational surface -------------------------------------------------

    def flush_windows(self) -> Frame:
        """Force-emit every open window (end-of-stream flush for batch
        jobs/tests; a serving loop should NOT call this — open windows
        belong in state across restarts)."""
        return self.engine.poll(force=True)

    def flow_stats(self) -> dict:
        """Operator evidence (state size, watermark, eviction/late
        counters, snapshots) for status dumps and run summaries."""
        return dict(
            self.engine.stats(),
            snapshots_published=self.snapshots_published,
            consumed_end=self._consumed_end,
            parser=self.parser(),
        )
