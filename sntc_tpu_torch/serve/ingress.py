"""Live network front door: socket ingress that WALs at the edge.

Counterpart of ``sntc_tpu/serve/ingress.py``: the spool files and
``ingress_stats.json`` have the JAX layouts, so each package's spool
sources serve the other's spool.

UDP datagrams are inherently lossy and non-replayable, so the serving
plane never processes them directly.  Instead the listeners here follow
Spark's reliable-receiver pattern — *persist first, then process from
the log*: every datagram/frame lands in a bounded in-memory ring, a
spooler thread seals ring contents into capture files atomically (fsync
file + containing dir around the rename — the storage plane's
discipline), and the
engine replays the sealed files through the ordinary directory sources.
WAL replay, admission, flow keying, the ingest autotuner, and the SLO
controller all compose unchanged because the spool IS a source
directory.

The loss-accounting law
-----------------------
Nothing is ever dropped silently.  Every payload that reaches the
receive boundary is either (a) sealed into a capture file, (b) still in
flight (ring/seal buffer — zero after :meth:`drain`), or (c) counted in
``sntc_ingress_dropped_total{reason}`` and the durable
``ingress_stats.json``.  After a drain::

    received == spooled + sum(dropped.values())

holds exactly — the conservation law the kill tests assert.

The backpressure ladder
-----------------------
1. **TCP pauses reads** while the spool exceeds its byte budget
   (``sntc_ingress_backpressure_state`` = 1); kernel TCP flow control
   pushes back to the sender, resuming below ~80% of budget.
2. **UDP ring overflow is counted shed** (``reason="ring_overflow"``):
   the ring bounds memory, the counter keeps the law.
3. **Disk budget breach sheds at ingress** (``reason=
   "spool_over_budget"``) after a committed-file prune attempt —
   bounded disk instead of ENOSPC death (the spool artifact's SHED
   policy).

Fault sites: ``ingress.recv`` guards the receive boundary (DATA kinds
corrupt the payload there, exactly like ``source.parse``);
``ingress.spool`` guards the seal (IO kinds + ``kill`` — the
kill-mid-spool scenario).  A kill between a sender's send and the
seal rename loses nothing the sender still holds: the atomic rename is
the ack, so resend-until-sealed gives exactly-once into the spool.

A daemon tenant's spool, listeners and ``build_ingress`` take its
``tenant``: the fault sites are looked up as ``tenant/<id>/ingress.*``
first, the ``sntc_ingress_*`` series carry its label and the ingress
events its ``"tenant"`` key (None outside a daemon, as in the JAX
package).
"""

from __future__ import annotations

import glob
import json
import os
import re
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from sntc_tpu_torch.obs.metrics import inc, set_gauge
from sntc_tpu_torch.resilience.faults import fault_data, fault_point
from sntc_tpu_torch.resilience.policy import emit_event
from sntc_tpu_torch.resilience.storage import atomic_write_bytes, write_marker
from sntc_tpu_torch.serve.netflow_source import NetFlowDirSource
from sntc_tpu_torch.serve.streaming import FileStreamSource

STATS_FILE = "ingress_stats.json"
QUARANTINE_DIR = "quarantine"

#: TCP framing: 4-byte big-endian payload length, then the payload (one
#: utf-8 CSV row, no trailing newline).
FRAME_HEADER = struct.Struct(">I")

_IDX_RE = re.compile(r"(\d+)")


def _labels(tenant: Optional[str]) -> Dict[str, str]:
    return {} if tenant is None else {"tenant": tenant}


def _file_index(path: str) -> int:
    """The monotonic sequence index encoded in a spool file name
    (``capture_000123.nf5`` -> 123)."""
    m = _IDX_RE.search(os.path.basename(path))
    if m is None:
        raise ValueError(f"spool file without sequence index: {path!r}")
    return int(m.group(1))


class IngressStats:
    """Thread-safe ingress accounting — the in-memory side of the
    conservation law.  Mirrored durably into ``ingress_stats.json`` at
    every seal/prune/drain, so harnesses (and operators) can audit the
    law across process death."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.received = 0
        self.received_bytes = 0
        self.spooled = 0
        self.sealed_files = 0
        self.pruned_files = 0
        self.quarantined = 0
        self.dropped: Dict[str, int] = {}
        self.drained = False

    def note_received(self, nbytes: int) -> None:
        with self._lock:
            self.received += 1
            self.received_bytes += nbytes

    def note_spooled(self, units: int) -> None:
        with self._lock:
            self.spooled += units
            self.sealed_files += 1

    def note_dropped(self, reason: str, units: int = 1) -> None:
        with self._lock:
            self.dropped[reason] = self.dropped.get(reason, 0) + units

    def note_pruned(self, files: int) -> None:
        with self._lock:
            self.pruned_files += files

    def note_quarantined(self) -> None:
        with self._lock:
            self.quarantined += 1

    def dropped_total(self) -> int:
        with self._lock:
            return sum(self.dropped.values())

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "received": self.received,
                "received_bytes": self.received_bytes,
                "spooled": self.spooled,
                "sealed_files": self.sealed_files,
                "pruned_files": self.pruned_files,
                "quarantined": self.quarantined,
                "dropped": dict(self.dropped),
                "drained": self.drained,
            }


class IngressSpool:
    """The durable, replayable ingress WAL: a directory of sealed
    capture files with monotonic sequence names, keep-N retention of
    COMMITTED files, and a disk-budget shed valve.

    Sequence names are derived from max-existing-index + 1 (never
    ``len(glob(...))`` — a pruned spool would reuse indices and
    silently overwrite live captures), so the name order IS the offset
    order and the numeric index IS the source offset: file ``i`` sits
    at listing position ``i`` once the pruned prefix is tombstoned
    (:class:`_SpoolOffsetMixin`).

    Retention only ever prunes files whose index is strictly below the
    engine's committed horizon (``committed_offset_fn``, wired to
    ``StreamingQuery.committed_end``): a file the engine has not
    committed past is never deleted, so replay after a crash always
    finds every uncommitted byte."""

    def __init__(
        self,
        spool_dir: str,
        *,
        prefix: str = "capture_",
        suffix: str = ".nf5",
        tenant: Optional[str] = None,
        keep_files: int = 64,
        spool_budget_mb: Optional[float] = None,
        committed_offset_fn: Optional[Callable[[], int]] = None,
    ) -> None:
        self.spool_dir = spool_dir
        self.prefix = prefix
        self.suffix = suffix
        self.tenant = tenant
        self.keep_files = max(1, int(keep_files))
        self.budget_bytes = (
            int(spool_budget_mb * (1 << 20)) if spool_budget_mb else None
        )
        self.committed_offset_fn = committed_offset_fn
        self.stats = IngressStats()
        self._lock = threading.RLock()
        # the durable stats file is accounting, not the WAL: throttle
        # its fsync off the hot seal path.  Exception: a prune MUST
        # write through, because index resume after a restart falls
        # back to stats only when pruning has removed the live files
        # that would otherwise witness the true max index.
        self._stats_written_at = 0.0
        self.stats_interval_s = 0.25
        os.makedirs(spool_dir, exist_ok=True)
        live = self._live_files()
        self._next_idx = (_file_index(live[-1]) + 1) if live else 0
        prior = self.read_stats(spool_dir)
        if prior:
            # a restart resumes the sequence past everything ever
            # sealed, even when retention has since pruned it all
            self._next_idx = max(
                self._next_idx, int(prior.get("sealed_files", 0))
            )
            self.stats.pruned_files = int(prior.get("pruned_files", 0))

    # -- introspection -------------------------------------------------------

    @staticmethod
    def read_stats(spool_dir: str) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(spool_dir, STATS_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _live_files(self) -> List[str]:
        return sorted(
            glob.glob(
                os.path.join(self.spool_dir, self.prefix + "*" + self.suffix)
            )
        )

    def spool_bytes(self) -> int:
        total = 0
        for p in self._live_files():
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def over_budget(self, headroom: float = 1.0) -> bool:
        if self.budget_bytes is None:
            return False
        return self.spool_bytes() > self.budget_bytes * headroom

    # -- the seal (the WAL append) -------------------------------------------

    def seal(self, payload: bytes, units: int, extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Atomically publish one capture file holding ``units``
        payloads.  Returns the sealed path, or None when the payload
        was SHED (budget) or lost to an injected/real IO fault — in
        both cases the loss is counted, never silent."""
        with self._lock:
            if self.budget_bytes is not None:
                projected = self.spool_bytes() + len(payload)
                if projected > self.budget_bytes:
                    # a budget prune may remove EVERY committed witness
                    # file: write the stats through before the seal's
                    # fault boundary, or a kill in the throttle window
                    # resumes at a stale next_idx and reuses sealed
                    # indices below the committed horizon
                    if self._prune(
                        budget_target=self.budget_bytes - len(payload)
                    ):
                        self._write_stats()
                    projected = self.spool_bytes() + len(payload)
                if projected > self.budget_bytes:
                    self.stats.note_dropped("spool_over_budget", units)
                    inc(
                        "sntc_ingress_dropped_total", units,
                        reason="spool_over_budget", **_labels(self.tenant),
                    )
                    emit_event(
                        event="ingress_shed", reason="spool_over_budget",
                        units=units, bytes=len(payload),
                        budget_bytes=self.budget_bytes, tenant=self.tenant,
                    )
                    self._write_stats()
                    return None
            path = os.path.join(
                self.spool_dir,
                f"{self.prefix}{self._next_idx:06d}{self.suffix}",
            )
            try:
                # the kill-mid-spool boundary: a kill here leaves
                # no sealed file, so a resend-until-sealed sender loses
                # nothing; IO kinds model the full/failing disk
                fault_point("ingress.spool", tenant=self.tenant)
                atomic_write_bytes(  # storage: ingress_spool
                    path, payload, site="ingress.spool", tenant=self.tenant)
            except Exception as e:
                # the artifact's SHED policy: a failing spool disk sheds
                # at ingress (counted) instead of killing the listener
                self.stats.note_dropped("spool_error", units)
                inc("sntc_ingress_dropped_total", units, reason="spool_error",
                    **_labels(self.tenant))
                emit_event(
                    event="ingress_shed", reason="spool_error",
                    units=units, error=repr(e), tenant=self.tenant,
                )
                self._write_stats()
                return None
            self._next_idx += 1
            self.stats.note_spooled(units)
            inc("sntc_ingress_sealed_files_total", 1, **_labels(self.tenant))
            set_gauge("sntc_ingress_spool_bytes", self.spool_bytes(),
                      **_labels(self.tenant))
            pruned = self._prune()
            # a seal landing within one file of the retention horizon
            # is immediately prunable: its stats write must not wait
            # out the throttle window, or a kill inside it leaves no
            # witness — neither a live file nor current stats — of the
            # sealed index
            near_horizon = False
            if self.committed_offset_fn is not None:
                try:
                    near_horizon = (
                        self._next_idx - int(self.committed_offset_fn())
                        <= 2
                    )
                except Exception:
                    near_horizon = False
            if (
                pruned
                or near_horizon
                or time.monotonic() - self._stats_written_at
                >= self.stats_interval_s
            ):
                self._write_stats(extra)
            return path

    def quarantine(self, data: bytes, reason: str) -> Optional[str]:
        """Preserve undecodable evidence (a torn TCP frame) under
        ``quarantine/`` — dropped from the stream (counted) but never
        destroyed."""
        qdir = os.path.join(self.spool_dir, QUARANTINE_DIR)
        n = self.stats.quarantined
        path = os.path.join(qdir, f"{reason}_{os.getpid()}_{n:06d}.bin")
        try:
            atomic_write_bytes(
                path, data, site="ingress.spool", tenant=self.tenant)
        except Exception:
            path = None
        self.stats.note_quarantined()
        return path

    # -- retention (keep-N committed + budget shed) --------------------------

    def _prune(self, budget_target: Optional[int] = None) -> int:
        """Prune COMMITTED capture files: oldest-first, only files the
        engine has committed past, down to ``keep_files`` retained
        committed files (or ``budget_target`` bytes when given).
        Without a committed-offset feed nothing is pruned — bounding
        falls to the budget shed valve, which drops NEW payloads
        instead of replayable history."""
        if self.committed_offset_fn is None:
            return 0
        try:
            horizon = int(self.committed_offset_fn())
        except Exception:
            return 0
        live = self._live_files()
        committed = [p for p in live if _file_index(p) < horizon]
        if budget_target is None:
            drop = (
                committed[: -self.keep_files]
                if len(committed) > self.keep_files else []
            )
        else:
            drop, total = [], self.spool_bytes()
            for p in committed:
                if total <= budget_target:
                    break
                try:
                    total -= os.path.getsize(p)
                except OSError:
                    pass
                drop.append(p)
        pruned = 0
        for p in drop:
            try:
                os.unlink(p)
                pruned += 1
            except OSError:
                pass
        if pruned:
            self.stats.note_pruned(pruned)
            inc("sntc_ingress_pruned_files_total", pruned,
                **_labels(self.tenant))
            emit_event(
                event="ingress_pruned", files=pruned, horizon=horizon,
                tenant=self.tenant,
            )
        return pruned

    # -- durable accounting --------------------------------------------------

    def _write_stats(self, extra: Optional[Dict[str, Any]] = None) -> None:
        obj = self.stats.snapshot()
        obj["next_idx"] = self._next_idx
        if extra:
            obj.update(extra)
        write_marker(os.path.join(self.spool_dir, STATS_FILE), obj,
                     tenant=self.tenant)
        self._stats_written_at = time.monotonic()

    def publish_stats(self, **extra: Any) -> None:
        with self._lock:
            self._write_stats(extra or None)


def _recv_boundary(data: bytes, tenant: Optional[str] = None) -> bytes:
    """The shared receive-boundary fault hook: ``ingress.recv`` takes
    exception kinds (a failing NIC/driver read) AND the DATA kinds
    (corrupt/truncated datagrams — downstream parse salvage must hold
    over network input exactly as over disk input)."""
    fault_point("ingress.recv", tenant=tenant)
    return fault_data("ingress.recv", data)


class _ListenerBase:
    """Shared ring + spooler machinery of both listeners: payloads
    enter through :meth:`_ingest` (socket threads or tests), a spooler
    thread groups and seals them, :meth:`drain` stops intake and seals
    the tail, :meth:`close` tears down."""

    def __init__(
        self,
        spool: IngressSpool,
        *,
        ring_size: int,
        seal_units: int,
        seal_idle_s: float,
        tenant: Optional[str] = None,
    ) -> None:
        self.spool = spool
        self.stats = spool.stats
        self.tenant = tenant
        self.ring_size = max(1, int(ring_size))
        self.seal_units = max(1, int(seal_units))
        self.seal_idle_s = float(seal_idle_s)
        self._ring: List[bytes] = []
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._discard = False
        self._threads: List[threading.Thread] = []
        self._started = False

    # -- intake --------------------------------------------------------------

    def _ingest(self, data: bytes) -> None:
        """One payload past the receive boundary and into the ring —
        the unit the conservation law counts."""
        data = _recv_boundary(data, self.tenant)
        self.stats.note_received(len(data))
        inc(self._recv_metric, 1, **_labels(self.tenant))
        inc("sntc_ingress_bytes_total", len(data), **_labels(self.tenant))
        with self._cv:
            if len(self._ring) >= self.ring_size:
                # the UDP rung of the backpressure ladder: bounded
                # memory, counted shed — never silent loss
                self.stats.note_dropped("ring_overflow", 1)
                inc("sntc_ingress_dropped_total", 1, reason="ring_overflow",
                    **_labels(self.tenant))
            else:
                self._ring.append(data)
                self._cv.notify()
            set_gauge("sntc_ingress_ring_depth", len(self._ring),
                          **_labels(self.tenant))

    # -- the spooler thread --------------------------------------------------

    def _spool_loop(self) -> None:
        buf: List[bytes] = []
        last_activity = time.monotonic()
        while True:
            moved = 0
            with self._cv:
                if not self._ring and not self._stop.is_set():
                    self._cv.wait(timeout=max(0.02, self.seal_idle_s / 4))
                while self._ring and len(buf) < self.seal_units:
                    buf.append(self._ring.pop(0))
                    moved += 1
                ring_empty = not self._ring
                set_gauge("sntc_ingress_ring_depth", len(self._ring),
                          **_labels(self.tenant))
            if moved:
                # the idle clock restarts only on ARRIVALS — a partial
                # group merely sitting in buf must age toward the tail
                # seal, not refresh itself every wakeup
                last_activity = time.monotonic()
            stopping = self._stop.is_set()
            if self._discard:
                if buf:
                    self.stats.note_dropped("close_discard", len(buf))
                    inc(
                        "sntc_ingress_dropped_total", len(buf),
                        reason="close_discard", **_labels(self.tenant),
                    )
                    buf = []
                if stopping and ring_empty:
                    return
                continue
            if len(buf) >= self.seal_units:
                self._seal(buf)
                buf = []
            elif buf and (
                stopping
                or time.monotonic() - last_activity >= self.seal_idle_s
            ):
                # tail seal: a drain (or an idle gap) must not strand
                # a partial group in memory
                self._seal(buf)
                buf = []
            if stopping and ring_empty and not buf:
                return

    def _seal(self, buf: List[bytes]) -> None:
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._started:
            return self
        self._started = True
        t = threading.Thread(
            target=self._spool_loop, name="sntc-ingress-spool", daemon=True
        )
        t.start()
        self._threads.append(t)
        self._start_io_threads()
        self.spool.publish_stats(**self._endpoint())
        return self

    def _start_io_threads(self) -> None:
        pass

    def _endpoint(self) -> Dict[str, Any]:
        return {}

    def drain(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        """Graceful stop: no new intake, ring + tail sealed, stats
        published with ``drained=true``.  After this the conservation
        law holds exactly: received == spooled + dropped."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        deadline = time.monotonic() + timeout_s
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self.stats.drained = True
        self.spool.publish_stats(**self._endpoint())
        emit_event(
            event="ingress_drained", tenant=self.tenant,
            **self.stats.snapshot(),
        )
        return self.stats.snapshot()

    def close(self) -> None:
        """Hard stop: pending ring contents are DISCARDED — but
        counted (``reason="close_discard"``), keeping the law."""
        if not self._stop.is_set():
            self._discard = True
        self.drain(timeout_s=5.0)


class UdpIngressListener(_ListenerBase):
    """Supervised UDP ingress: a receiver thread drains NetFlow v5
    datagrams into the bounded ring, the spooler seals
    ``seal_datagrams`` of them per capture file (concatenated datagrams
    — exactly the on-disk shape ``NetFlowDirSource`` replays).  Binding
    ``port=0`` picks an ephemeral port, published in
    ``ingress_stats.json`` (``port``) for harnesses."""

    _recv_metric = "sntc_ingress_datagrams_total"

    def __init__(
        self,
        spool: IngressSpool,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        sock: Optional[socket.socket] = None,
        ring_datagrams: int = 2048,
        seal_datagrams: int = 30,
        seal_idle_s: float = 0.25,
        recv_timeout_s: float = 0.2,
        tenant: Optional[str] = None,
    ) -> None:
        super().__init__(
            spool, ring_size=ring_datagrams, seal_units=seal_datagrams,
            seal_idle_s=seal_idle_s, tenant=tenant,
        )
        self._own_sock = sock is None
        if sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                # NetFlow exporters burst; the default ~200 KiB kernel
                # buffer holds only a handful of full datagrams.  Ask
                # for 4 MiB (the kernel caps at net.core.rmem_max) so
                # bursts land in OUR counted ring, not in an uncounted
                # kernel drop.
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22
                )
            except OSError:
                pass
            sock.bind((host, port))
        sock.settimeout(recv_timeout_s)
        self.sock = sock
        self.host, self.port = sock.getsockname()[:2]

    def _endpoint(self) -> Dict[str, Any]:
        return {"port": self.port, "proto": "udp"}

    def _start_io_threads(self) -> None:
        t = threading.Thread(
            target=self._rx_loop, name="sntc-ingress-udp", daemon=True
        )
        t.start()
        self._threads.append(t)

    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65_535)
            except socket.timeout:
                continue
            except OSError:
                break  # socket closed under us: a drain/close is in flight
            try:
                self._ingest(data)
            except Exception as e:
                # an injected (or real) receive failure drops ONE
                # datagram, counted — it must not kill the listener.
                # The corrupt arrival still counts as received, so the
                # conservation law stays an equality.
                self.stats.note_received(len(data))
                self.stats.note_dropped("recv_error", 1)
                inc("sntc_ingress_dropped_total", 1, reason="recv_error",
                    **_labels(self.tenant))
                emit_event(
                    event="ingress_recv_error", error=repr(e),
                    tenant=self.tenant,
                )
        if self._own_sock:
            try:
                self.sock.close()
            except OSError:
                pass

    def _seal(self, buf: List[bytes]) -> None:
        self.spool.seal(b"".join(buf), units=len(buf), extra=self._endpoint())


class TcpRowIngress(_ListenerBase):
    """Framed TCP row ingest — the "millions of clients" shape: each
    connection sends length-prefixed utf-8 CSV rows (4-byte big-endian
    length, then the row).  Rows seal into ``rows_NNNNNN.csv`` files
    (header + rows) that ``FileStreamSource``/``CsvSpoolSource``
    replay.

    Per-connection framing is independent: a client that dies
    mid-frame quarantines its torn tail (``quarantine/``, counted
    ``torn_frame``) without touching any other connection.  While the
    spool is over budget the reader threads PAUSE between frames —
    kernel TCP flow control turns that pause into sender backpressure
    (``sntc_ingress_backpressure_state`` = 1)."""

    _recv_metric = "sntc_ingress_frames_total"

    def __init__(
        self,
        spool: IngressSpool,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        sock: Optional[socket.socket] = None,
        columns: Optional[List[str]] = None,
        ring_frames: int = 4096,
        seal_rows: int = 256,
        seal_idle_s: float = 0.25,
        max_frame_bytes: int = 1 << 20,
        accept_timeout_s: float = 0.2,
        tenant: Optional[str] = None,
    ) -> None:
        super().__init__(
            spool, ring_size=ring_frames, seal_units=seal_rows,
            seal_idle_s=seal_idle_s, tenant=tenant,
        )
        self.columns = list(columns) if columns else None
        self.max_frame_bytes = int(max_frame_bytes)
        self._own_sock = sock is None
        if sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
        sock.listen(32)
        sock.settimeout(accept_timeout_s)
        self.sock = sock
        self.host, self.port = sock.getsockname()[:2]
        self._conns = 0
        self._conn_lock = threading.Lock()

    def _endpoint(self) -> Dict[str, Any]:
        return {"tcp_port": self.port, "proto": "tcp"}

    def _start_io_threads(self) -> None:
        t = threading.Thread(
            target=self._accept_loop, name="sntc-ingress-tcp", daemon=True
        )
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        handlers: List[threading.Thread] = []
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            h = threading.Thread(
                target=self._conn_loop, args=(conn,),
                name="sntc-ingress-conn", daemon=True,
            )
            h.start()
            handlers.append(h)
        if self._own_sock:
            try:
                self.sock.close()
            except OSError:
                pass
        # a drain waits for in-flight connections to settle (each
        # reader exits at its next frame boundary once _stop is set)
        for h in handlers:
            h.join(timeout=5.0)

    def _conn_gauge(self, delta: int) -> None:
        with self._conn_lock:
            self._conns += delta
            set_gauge("sntc_ingress_connections", self._conns,
                      **_labels(self.tenant))

    def _recv_exact(self, conn: socket.socket, n: int) -> bytes:
        """Read exactly ``n`` bytes; returns the SHORT prefix when the
        peer closes mid-read (the torn-frame evidence)."""
        chunks = []
        got = 0
        while got < n and not self._stop.is_set():
            try:
                chunk = conn.recv(min(65_536, n - got))
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def _conn_loop(self, conn: socket.socket) -> None:
        conn.settimeout(0.2)
        self._conn_gauge(+1)
        try:
            while not self._stop.is_set():
                # rung 1 of the backpressure ladder: stop reading while
                # the spool is over budget; resume below 80% of it
                if self.spool.over_budget():
                    set_gauge("sntc_ingress_backpressure_state", 1,
                              **_labels(self.tenant))
                    while (
                        self.spool.over_budget(headroom=0.8)
                        and not self._stop.is_set()
                    ):
                        time.sleep(0.02)
                    set_gauge("sntc_ingress_backpressure_state", 0,
                              **_labels(self.tenant))
                header = self._recv_exact(conn, FRAME_HEADER.size)
                if not header:
                    break  # clean close at a frame boundary
                if len(header) < FRAME_HEADER.size:
                    self._torn(header)
                    break
                (length,) = FRAME_HEADER.unpack(header)
                if length > self.max_frame_bytes:
                    # an unframeable stream cannot be resynced: drop
                    # the frame, close the connection (the arrival is
                    # still counted received — the law is an equality)
                    self.stats.note_received(len(header))
                    self.stats.note_dropped("oversize_frame", 1)
                    inc(
                        "sntc_ingress_dropped_total", 1,
                        reason="oversize_frame", **_labels(self.tenant),
                    )
                    break
                payload = self._recv_exact(conn, length)
                if len(payload) < length:
                    self._torn(header + payload)
                    break
                try:
                    self._ingest(payload)
                except Exception as e:
                    self.stats.note_received(len(payload))
                    self.stats.note_dropped("recv_error", 1)
                    inc("sntc_ingress_dropped_total", 1, reason="recv_error",
                        **_labels(self.tenant))
                    emit_event(
                        event="ingress_recv_error", error=repr(e),
                        tenant=self.tenant,
                    )
        finally:
            try:
                conn.close()
            except OSError:
                pass
            self._conn_gauge(-1)

    def _torn(self, partial: bytes) -> None:
        self.spool.quarantine(partial, "torn_frame")
        # the torn bytes DID arrive: received counts them so the
        # conservation law (received == spooled + dropped) stays exact
        self.stats.note_received(len(partial))
        self.stats.note_dropped("torn_frame", 1)
        inc("sntc_ingress_dropped_total", 1, reason="torn_frame",
            **_labels(self.tenant))
        emit_event(
            event="ingress_torn_frame", bytes=len(partial),
            tenant=self.tenant,
        )

    def _seal(self, buf: List[bytes]) -> None:
        lines: List[str] = []
        if self.columns:
            lines.append(",".join(self.columns))
        lines.extend(b.decode("utf-8", "replace") for b in buf)
        payload = ("\n".join(lines) + "\n").encode()
        self.spool.seal(payload, units=len(buf), extra=self._endpoint())


# ---------------------------------------------------------------------------
# replayable sources over a pruned spool (tombstone offsets)
# ---------------------------------------------------------------------------

#: listing placeholder for a retention-pruned capture file — it holds
#: the file's OFFSET position so pruning never renumbers live files
#: (renumbering would silently replay or skip under the engine's WAL)
PRUNED = "<pruned>"


class _SpoolOffsetMixin:
    """Directory-source mixin that keeps source offsets STABLE across
    spool retention: offset ``i`` is capture file index ``i`` forever.
    The listing is the live files left-padded with :data:`PRUNED`
    tombstones — one per pruned predecessor, derived from the first
    live file's sequence index (pruning is oldest-first and names are
    contiguous from 0, so the first live index IS the pruned count;
    with an empty spool the durable ``ingress_stats.json`` carries the
    horizon across restarts).  Reading a tombstoned offset raises —
    retention only prunes below the committed horizon, so a planned
    batch can only hit one if the WAL was deleted out from under the
    spool."""

    def _scan(self) -> List[str]:
        real = sorted(glob.glob(os.path.join(self.path, self.pattern)))
        if real:
            floor = _file_index(real[0])
        else:
            stats = IngressSpool.read_stats(self.path)
            floor = int(stats.get("pruned_files", 0)) if stats else 0
        prior = getattr(self, "_floor", 0)
        self._floor = max(floor, prior)
        return [PRUNED] * self._floor + real

    def _files(self) -> List[str]:
        self._listing = self._scan()
        return self._listing

    def files_for_range(self, start: int, end: int) -> List[str]:
        listing = self._listing
        if listing is None or len(listing) < end:
            listing = self._scan()
        return [f for f in listing[start:end] if f is not PRUNED]

    def _read_range(self, start, end, listing):
        if listing is None or len(listing) < end:
            listing = self._scan()
        files = listing[start:end]
        if any(f is PRUNED for f in files):
            raise ValueError(
                f"batch range [{start}, {end}) is below the spool "
                "retention horizon (pruned capture files) — the "
                "offset WAL does not match this spool"
            )
        return super()._read_range(start, end, listing)

    # -- listener attachment (daemon/serve lifecycle hooks) ------------------

    def attach_listener(self, listener) -> None:
        self._listeners = getattr(self, "_listeners", [])
        self._listeners.append(listener)

    def drain_ingress(self) -> None:
        """Settle the attached listeners BEFORE the engine drains, so
        tail datagrams seal in time to be served by the final batches."""
        for l in getattr(self, "_listeners", []):
            try:
                l.drain()
            except Exception:
                pass

    def close(self) -> None:
        for l in getattr(self, "_listeners", []):
            try:
                l.close()
            except Exception:
                pass
        super().close()


class NetFlowSpoolSource(_SpoolOffsetMixin, NetFlowDirSource):
    """NetFlow capture source over a retention-pruned ingress spool."""

    def __init__(self, path: str, pattern: str = "capture_*.nf5", **kwargs):
        super().__init__(path, pattern, **kwargs)


class CsvSpoolSource(_SpoolOffsetMixin, FileStreamSource):
    """CSV row source over a retention-pruned ingress spool."""

    def __init__(self, path: str, pattern: str = "rows_*.csv", **kwargs):
        super().__init__(path, pattern, **kwargs)


# ---------------------------------------------------------------------------
# client-side framing + wiring helpers
# ---------------------------------------------------------------------------


def frame_rows(rows: List[str]) -> bytes:
    """Length-prefix ``rows`` for :class:`TcpRowIngress` (the client
    half of the framing contract)."""
    return b"".join(
        FRAME_HEADER.pack(len(r)) + r
        for r in (row.encode() for row in rows)
    )


def build_ingress(
    spool_dir: str,
    *,
    listen_udp: Optional[int] = None,
    listen_tcp: Optional[int] = None,
    spool_mb: Optional[float] = None,
    keep_files: int = 64,
    ring: int = 2048,
    seal_every: int = 30,
    seal_idle_s: float = 0.25,
    columns: Optional[List[str]] = None,
    tenant: Optional[str] = None,
    source_kwargs: Optional[Dict[str, Any]] = None,
) -> Tuple[Any, List[Any]]:
    """Build (source, listeners) for one ingress endpoint: the spool
    directory doubles as the source's watch directory, the listeners
    are attached to the source (so source drain/close settles them),
    and the spool's retention horizon is wired to the engine by the
    caller via ``wire_committed_offset``."""
    if (listen_udp is None) == (listen_tcp is None):
        raise ValueError(
            "exactly one of listen_udp / listen_tcp must be given "
            "(one spool directory holds one capture format)"
        )
    kwargs = dict(source_kwargs or {})
    kwargs.setdefault("tenant", tenant)
    if listen_udp is not None:
        spool = IngressSpool(
            spool_dir, prefix="capture_", suffix=".nf5", tenant=tenant,
            keep_files=keep_files, spool_budget_mb=spool_mb,
        )
        listener = UdpIngressListener(
            spool, port=listen_udp, ring_datagrams=ring,
            seal_datagrams=seal_every, seal_idle_s=seal_idle_s,
            tenant=tenant,
        )
        source = NetFlowSpoolSource(spool_dir, **kwargs)
    else:
        spool = IngressSpool(
            spool_dir, prefix="rows_", suffix=".csv", tenant=tenant,
            keep_files=keep_files, spool_budget_mb=spool_mb,
        )
        listener = TcpRowIngress(
            spool, port=listen_tcp, ring_frames=ring,
            seal_rows=seal_every, seal_idle_s=seal_idle_s,
            columns=columns, tenant=tenant,
        )
        source = CsvSpoolSource(spool_dir, **kwargs)
    source.attach_listener(listener)
    source.spool = spool
    return source, [listener]


def wire_committed_offset(source, fn: Callable[[], int]) -> None:
    """Feed the engine's committed horizon into the spool's retention
    (call once the ``StreamingQuery`` exists:
    ``wire_committed_offset(src, query.committed_end)``)."""
    spool = getattr(source, "spool", None)
    if spool is not None:
        spool.committed_offset_fn = fn
