"""Stateful keyed-window flow metering — the Structured-Streaming
stateful-operator analog over raw captures [B:11].

The batch path (``native/pcap.py``/``native/netflow.py``) meters a
WHOLE capture at once, so a flow split across two micro-batch files
would emit as two half-windows.  :class:`FlowFeatureEngine` closes that
gap: it buffers the packet/datagram records the native parsers produce
per bidirectional 5-tuple key, advances an event-time **watermark**
(``max event ts seen − allowed_lateness``), and emits a flow's
CICIDS2017 feature row only once the watermark proves the window
COMPLETE — no admissible future record can extend it (a session window
closes when ``watermark − last_ts > flow_timeout``: any record the
lateness policy would still accept has ``ts ≥ watermark``, whose gap to
the window exceeds the session timeout and therefore starts a NEW
window).  Records inside the lateness bound may arrive out of order
(counted, reordered at emit); records behind the watermark are dropped
with the reason code ``late_record`` — the row admission discipline
applied to event time.

Feature math is NOT reimplemented here: emission concatenates the
completed windows' raw records and defers to the same hardened meters
the batch path uses (``packets_to_flow_frame`` — one lexsort +
segment-reduction pass, the sufficient-statistic discipline
``partial_fit`` shares — and a record-merge + ``netflow_to_flow_frame``
for NetFlow), so windowed serving and whole-capture metering can never
drift apart and golden tests pin one implementation.

State is a first-class crash-safety citizen: :meth:`snapshot` /
:meth:`restore` round-trip the operator state bytes the
:class:`~sntc_tpu_torch.flow.state.FlowStateStore` persists at every engine
commit (see ``flow/source.py`` for the snapshot-at-commit
protocol), and emission is a pure function of (state, consumed range) —
WAL replay from the last checkpoint reproduces the same windows
**bitwise**.  Watermark eviction plus the ``max_state_packets`` cap
bound state size under arbitrary out-of-order replay (``state_cap``
evictions force the oldest flows out early; documented best-effort
splits).  Everything surfaces as catalogued ``sntc_flow_*`` metrics
(``obs/metrics.py``) and structured events.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.native import (
    NF5_FIELDS,
    PCAP_FIELDS,
    netflow_to_flow_frame,
    packets_to_flow_frame,
)
from sntc_tpu_torch.obs.metrics import inc, set_gauge
from sntc_tpu_torch.resilience import emit_event, fault_point

# NF5 column indexes the NetFlow meter reads (``native/netflow.py``
# NF5_FIELD_NAMES order)
_NF_SRC, _NF_DST, _NF_SPORT, _NF_DPORT, _NF_PROTO = 0, 1, 2, 3, 4
_NF_FLAGS, _NF_PKTS, _NF_OCTETS = 5, 7, 8
_NF_FIRST, _NF_LAST, _NF_DUR = 9, 10, 15


class PcapFlowMeter:
    """Keying + emission over pcap packet rows (``[n, PCAP_FIELDS]``).

    The key is the bidirectional (order-free) 5-tuple — the same
    ``lo/hi`` endpoint canonicalization ``packets_to_flow_frame`` sorts
    by — and emission IS ``packets_to_flow_frame``, so a window the
    engine completes carries byte-for-byte the features the batch
    meter would compute from the same packets."""

    n_fields = PCAP_FIELDS

    def __init__(self, flow_timeout: float = 120.0,
                 activity_timeout: float = 5.0):
        self.flow_timeout = float(flow_timeout)
        self.activity_timeout = float(activity_timeout)

    def key_columns(self, records: np.ndarray) -> np.ndarray:
        src = records[:, 1].astype(np.int64)
        dst = records[:, 2].astype(np.int64)
        sport = records[:, 3].astype(np.int64)
        dport = records[:, 4].astype(np.int64)
        proto = records[:, 5].astype(np.int64)
        ep_a = src * 65536 + sport
        ep_b = dst * 65536 + dport
        return np.stack(
            [np.minimum(ep_a, ep_b), np.maximum(ep_a, ep_b), proto],
            axis=1,
        )

    def event_ts(self, records: np.ndarray) -> np.ndarray:
        return records[:, 0].astype(np.float64)

    def emit(self, records: np.ndarray) -> Frame:
        return packets_to_flow_frame(
            records,
            flow_timeout=self.flow_timeout,
            activity_timeout=self.activity_timeout,
        )


class NetFlowMeter:
    """Keying + emission over NetFlow v5 records (``[n, NF5_FIELDS]``).

    NetFlow is unidirectional, so the key is the DIRECTIONAL 5-tuple
    (as the exporter reports it).  Emission merges each completed
    window's records — packets/octets sum, flags OR, first/last
    min/max — into one record and lifts it through
    ``netflow_to_flow_frame``, i.e. a long flow the exporter cut into
    several records re-aggregates into one feature row.  Event time is
    the record's ``first`` timestamp (exporter sysuptime clock, ms →
    seconds); ``flow_timeout``/lateness are read on that clock."""

    n_fields = NF5_FIELDS

    def __init__(self, flow_timeout: float = 120.0):
        self.flow_timeout = float(flow_timeout)

    def key_columns(self, records: np.ndarray) -> np.ndarray:
        src = records[:, _NF_SRC].astype(np.int64)
        dst = records[:, _NF_DST].astype(np.int64)
        sport = records[:, _NF_SPORT].astype(np.int64)
        dport = records[:, _NF_DPORT].astype(np.int64)
        proto = records[:, _NF_PROTO].astype(np.int64)
        return np.stack(
            [src * 65536 + sport, dst * 65536 + dport, proto], axis=1
        )

    def event_ts(self, records: np.ndarray) -> np.ndarray:
        return records[:, _NF_FIRST].astype(np.float64) / 1000.0

    def emit(self, records: np.ndarray) -> Frame:
        n = records.shape[0]
        if n == 0:
            return netflow_to_flow_frame(
                np.zeros((0, NF5_FIELDS), np.float64)
            )
        ts = self.event_ts(records)
        keys = self.key_columns(records)
        order = np.lexsort((ts, keys[:, 2], keys[:, 1], keys[:, 0]))
        r = records[order]
        k = keys[order]
        t = ts[order]
        new_key = np.empty(n, bool)
        new_key[0] = True
        new_key[1:] = (k[1:] != k[:-1]).any(axis=1)
        gap = np.empty(n, np.float64)
        gap[0] = 0.0
        gap[1:] = t[1:] - t[:-1]
        new_flow = new_key | (gap > self.flow_timeout)
        starts = np.flatnonzero(new_flow)
        merged = r[starts].copy()  # first record carries the identity
        iflags = r[:, _NF_FLAGS].astype(np.int64)
        merged[:, _NF_PKTS] = np.add.reduceat(r[:, _NF_PKTS], starts)
        merged[:, _NF_OCTETS] = np.add.reduceat(r[:, _NF_OCTETS], starts)
        merged[:, _NF_FLAGS] = np.bitwise_or.reduceat(iflags, starts)
        merged[:, _NF_FIRST] = np.minimum.reduceat(r[:, _NF_FIRST], starts)
        merged[:, _NF_LAST] = np.maximum.reduceat(r[:, _NF_LAST], starts)
        merged[:, _NF_DUR] = np.maximum(
            merged[:, _NF_LAST] - merged[:, _NF_FIRST], 0
        )
        return netflow_to_flow_frame(merged)


class _FlowState:
    """One key's buffered window: record chunks in arrival order plus
    the first/last event timestamps (the eviction clock)."""

    __slots__ = ("chunks", "first_ts", "last_ts", "n")

    def __init__(self):
        self.chunks: List[np.ndarray] = []
        self.first_ts = float("inf")
        self.last_ts = float("-inf")
        self.n = 0


class FlowFeatureEngine:
    """The keyed session-window operator (module docstring has the
    semantics).  ``consume`` is atomic w.r.t. exceptions — grouping is
    computed before any state mutates — so an engine-level read retry
    that re-enters with the same records can never double-count."""

    def __init__(
        self,
        meter,
        allowed_lateness: float = 5.0,
        max_state_packets: int = 500_000,
        tenant: Optional[str] = None,
    ):
        if allowed_lateness < 0:
            raise ValueError("allowed_lateness must be >= 0")
        if max_state_packets < 1:
            raise ValueError("max_state_packets must be >= 1")
        self.meter = meter
        self.allowed_lateness = float(allowed_lateness)
        self.max_state_packets = int(max_state_packets)
        # a daemon tenant's label on the series and events
        self.tenant = tenant
        self._mlabels = {} if tenant is None else {"tenant": tenant}
        self._flows: Dict[Tuple[int, ...], _FlowState] = {}
        self._max_ts: Optional[float] = None
        self._packets = 0  # buffered records across all flows
        self.records_consumed = 0
        self.late_records = 0
        self.out_of_order = 0
        self.windows_emitted = 0
        self.evictions: Dict[str, int] = {}
        # undo record for the MOST RECENT consume (per-key previous
        # first/last timestamps, prior clock + counters): lets the
        # source excise a quarantined batch whose records folded in
        # but whose windows never emitted (rollback_last_consume)
        self._last_undo: Optional[dict] = None

    # -- event-time bookkeeping ---------------------------------------------

    def watermark(self) -> Optional[float]:
        """``max event ts seen − allowed_lateness`` (None before any
        record): records behind it are late, windows idle more than
        ``flow_timeout`` behind it are complete."""
        if self._max_ts is None:
            return None
        return self._max_ts - self.allowed_lateness

    def state_size(self) -> Dict[str, int]:
        return {"flows": len(self._flows), "packets": self._packets}

    def _publish_gauges(self) -> None:
        set_gauge("sntc_flow_active_flows", len(self._flows),
                  **self._mlabels)
        set_gauge("sntc_flow_state_packets", self._packets, **self._mlabels)

    # -- consume -------------------------------------------------------------

    def consume(self, records: np.ndarray) -> Dict[str, int]:
        """Fold one micro-batch of parser records into the keyed state;
        returns ``{accepted, late, out_of_order}`` for the batch."""
        records = np.asarray(records, np.float64)
        stats = {"accepted": 0, "late": 0, "out_of_order": 0}
        undo = {
            "max_ts": self._max_ts,
            "counters": (self.records_consumed, self.late_records,
                         self.out_of_order),
            "keys": [],
        }
        if records.shape[0]:
            ts = self.meter.event_ts(records)
            wm = self.watermark()
            if wm is not None:
                late = ts < wm
            else:
                late = np.zeros(records.shape[0], bool)
            keep = ~late
            n_late = int(np.count_nonzero(late))
            n_ooo = (
                0 if self._max_ts is None
                else int(np.count_nonzero(keep & (ts < self._max_ts)))
            )
            records, ts = records[keep], ts[keep]
            stats["late"] = n_late
            stats["out_of_order"] = n_ooo
            if n_late:
                self.late_records += n_late
                inc("sntc_flow_late_records_total", n_late, **self._mlabels)
                emit_event(
                    event="flow_late_records", site="flow.emit",
                    reason="late_record", count=n_late,
                    watermark=wm, **self._mlabels,
                )
            if n_ooo:
                self.out_of_order += n_ooo
                inc("sntc_flow_out_of_order_total", n_ooo, **self._mlabels)
        if records.shape[0]:
            # grouping is computed in FULL before any mutation, then
            # applied in a plain append pass that cannot realistically
            # raise — a retry that re-enters after a downstream failure
            # must never find half a batch folded in
            keys = self.meter.key_columns(records)
            uniq, inv = np.unique(keys, axis=0, return_inverse=True)
            order = np.argsort(inv, kind="stable")
            bounds = np.searchsorted(inv[order], np.arange(len(uniq)))
            bounds = np.append(bounds, len(order))
            staged = []
            for j in range(len(uniq)):
                sel = order[bounds[j]:bounds[j + 1]]
                seg_ts = ts[sel]
                staged.append((
                    tuple(int(v) for v in uniq[j]), records[sel],
                    float(seg_ts.min()), float(seg_ts.max()),
                ))
            self._max_ts = (
                float(ts.max()) if self._max_ts is None
                else max(self._max_ts, float(ts.max()))
            )
            for key, chunk, tmin, tmax in staged:
                st = self._flows.get(key)
                undo["keys"].append((
                    key,
                    None if st is None else (st.first_ts, st.last_ts),
                ))
                if st is None:
                    st = self._flows[key] = _FlowState()
                st.chunks.append(chunk)
                st.n += len(chunk)
                st.first_ts = min(st.first_ts, tmin)
                st.last_ts = max(st.last_ts, tmax)
            self._packets += records.shape[0]
            stats["accepted"] = int(records.shape[0])
            self.records_consumed += stats["accepted"]
            inc("sntc_flow_records_consumed_total", stats["accepted"],
                **self._mlabels)
        self._last_undo = undo
        self._publish_gauges()
        return stats

    def rollback_last_consume(self) -> bool:
        """Excise the most recent consume's records from keyed state
        (a quarantined batch whose windows never emitted must not
        poison later batches' polls or the committed snapshot).  Only
        valid while no poll has SUCCEEDED since that consume — poll
        mutates nothing on failure, so the state delta is exactly the
        consume's per-key appends.  Returns True when rolled back."""
        undo = self._last_undo
        if undo is None:
            return False
        for key, prev in undo["keys"]:
            st = self._flows.get(key)
            if st is None or not st.chunks:  # pragma: no cover
                continue
            chunk = st.chunks.pop()
            st.n -= len(chunk)
            self._packets -= len(chunk)
            if prev is None or st.n == 0:
                del self._flows[key]
            else:
                st.first_ts, st.last_ts = prev
        self._max_ts = undo["max_ts"]
        (self.records_consumed, self.late_records,
         self.out_of_order) = undo["counters"]
        self._last_undo = None
        self._publish_gauges()
        return True

    # -- eviction / emission -------------------------------------------------

    def _complete_keys(self) -> List[Tuple[int, ...]]:
        wm = self.watermark()
        if wm is None:
            return []
        bound = wm - self.meter.flow_timeout
        return [k for k, st in self._flows.items() if st.last_ts < bound]

    def poll(self, force: bool = False) -> Frame:
        """Evict every completed window (plus the oldest flows while
        the ``max_state_packets`` cap is exceeded; everything with
        ``force=True`` — the explicit flush) and emit their feature
        rows as one Frame.  Deterministic given (state, watermark):
        the WAL-replay convergence contract rests on it."""
        evicted: List[Tuple[Tuple[int, ...], str]] = []
        if force:
            evicted = [(k, "flush") for k in self._flows]
        else:
            evicted = [(k, "watermark") for k in self._complete_keys()]
            remaining = self._packets - sum(
                self._flows[k].n for k, _ in evicted
            )
            if remaining > self.max_state_packets:
                # cap pressure: force the oldest still-open flows out
                # early (their window splits — documented best-effort)
                open_keys = sorted(
                    (k for k in self._flows
                     if k not in {e[0] for e in evicted}),
                    key=lambda k: (self._flows[k].last_ts, k),
                )
                for k in open_keys:
                    if remaining <= self.max_state_packets:
                        break
                    remaining -= self._flows[k].n
                    evicted.append((k, "state_cap"))
        if not evicted:
            self._publish_gauges()
            return self.meter.emit(
                np.zeros((0, self.meter.n_fields), np.float64)
            )
        # kill point: state selected for eviction but nothing removed
        # or emitted yet (the ``flow.evict`` kill scenario)
        fault_point("flow.evict", tenant=self.tenant)
        # deterministic emission order: windows sorted by (first_ts,
        # key); the meter's own lexsort is stable on top of this
        evicted.sort(key=lambda e: (self._flows[e[0]].first_ts, e[0]))
        parts: List[np.ndarray] = []
        for key, _reason in evicted:
            parts.extend(self._flows[key].chunks)
        # emit BEFORE any state mutates: a failure here (injected or
        # real) leaves the engine exactly as it was, so the caller's
        # retry re-polls the same eviction set instead of losing it
        frame = self.meter.emit(np.concatenate(parts, axis=0))
        reasons: Dict[str, int] = {}
        for key, reason in evicted:
            st = self._flows.pop(key)
            self._packets -= st.n
            reasons[reason] = reasons.get(reason, 0) + 1
        self.windows_emitted += frame.num_rows
        inc("sntc_flow_windows_emitted_total", frame.num_rows,
            **self._mlabels)
        for reason, count in sorted(reasons.items()):
            self.evictions[reason] = self.evictions.get(reason, 0) + count
            inc("sntc_flow_evictions_total", count, reason=reason,
                **self._mlabels)
        emit_event(
            event="flow_windows_emitted", site="flow.evict",
            windows=frame.num_rows, flows_evicted=len(evicted),
            reasons=reasons, watermark=self.watermark(), **self._mlabels,
        )
        self._publish_gauges()
        return frame

    # -- snapshot / restore --------------------------------------------------

    def snapshot(self) -> bytes:
        """Serialize the operator state (flows in sorted-key order,
        each flow's records in arrival order, plus the watermark clock
        and counters).  ``restore(snapshot())`` followed by the same
        consume/poll sequence reproduces the same emissions bitwise —
        the property the snapshot-at-commit protocol needs."""
        import io
        import json

        keys = sorted(self._flows)
        counts = np.asarray(
            [self._flows[k].n for k in keys], np.int64
        ).reshape(-1)
        key_arr = (
            np.asarray(keys, np.int64)
            if keys else np.zeros((0, 3), np.int64)
        )
        if keys:
            records = np.concatenate(
                [c for k in keys for c in self._flows[k].chunks], axis=0
            )
        else:
            records = np.zeros((0, self.meter.n_fields), np.float64)
        buf = io.BytesIO()
        np.savez(buf, keys=key_arr, counts=counts, records=records)
        header = {
            "version": 1,
            "max_ts": self._max_ts,
            "records_consumed": self.records_consumed,
            "late_records": self.late_records,
            "out_of_order": self.out_of_order,
            "windows_emitted": self.windows_emitted,
            "evictions": self.evictions,
            "n_flows": len(keys),
        }
        return json.dumps(header).encode() + b"\n" + buf.getvalue()

    def restore(self, payload: bytes) -> None:
        import io
        import json

        head, _, body = payload.partition(b"\n")
        header = json.loads(head.decode())
        if header.get("version") != 1:
            raise ValueError(
                f"unsupported flow-state version {header.get('version')}"
            )
        with np.load(io.BytesIO(body)) as z:
            keys, counts, records = z["keys"], z["counts"], z["records"]
        self._flows = {}
        self._packets = 0
        off = 0
        for i in range(keys.shape[0]):
            n = int(counts[i])
            st = _FlowState()
            chunk = records[off:off + n].copy()
            st.chunks = [chunk]
            st.n = n
            seg_ts = self.meter.event_ts(chunk)
            st.first_ts = float(seg_ts.min())
            st.last_ts = float(seg_ts.max())
            self._flows[tuple(int(v) for v in keys[i])] = st
            self._packets += n
            off += n
        self._max_ts = header["max_ts"]
        self._last_undo = None
        self.records_consumed = header["records_consumed"]
        self.late_records = header["late_records"]
        self.out_of_order = header["out_of_order"]
        self.windows_emitted = header["windows_emitted"]
        self.evictions = dict(header["evictions"])
        self._publish_gauges()

    def stats(self) -> Dict[str, object]:
        """Operator evidence for status dumps and run summaries."""
        return {
            "records_consumed": self.records_consumed,
            "late_records": self.late_records,
            "out_of_order": self.out_of_order,
            "windows_emitted": self.windows_emitted,
            "evictions": dict(self.evictions),
            "watermark": self.watermark(),
            **self.state_size(),
        }
