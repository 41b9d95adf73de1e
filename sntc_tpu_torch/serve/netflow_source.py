"""Live NetFlow ingest for streaming inference [B:11].

Design: UDP datagrams are not replayable, so exactly-once streaming over
live NetFlow splits into (1) ``capture_udp`` — a collector that write-
ahead-logs raw datagrams to capture files, and (2) ``NetFlowDirSource`` —
a replayable micro-batch source over those files (offset = file count),
decoded by the native C++ parser (``native/``) and lifted into the
CICIDS2017 flow schema for the trained pipeline.  This mirrors Spark's
reliable-receiver pattern: persist first, then process from the log.
"""

from __future__ import annotations

import glob
import os
import socket
import warnings
from typing import List, Optional

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.native import netflow_to_flow_frame, parse_stream
from sntc_tpu_torch.obs.metrics import inc
from sntc_tpu_torch.resilience import fault_data
from sntc_tpu_torch.serve.streaming import DirStreamSource


class _CaptureDirSource(DirStreamSource):
    """Capture-file directory source: one decoded Frame per file.
    Subclasses implement ``_decode_file(bytes) -> Frame``.

    Inherits the full :class:`DirStreamSource` pipeline surface —
    per-tick listing cache, parallel per-file decodes
    (``read_workers``), background staging (``prefetch_batches``), the
    source-graph stage meters, and the live ``set_read_workers`` /
    ``set_prefetch_batches`` resize surface the ingest autotuner
    drives; decode is CPU-bound Python for pcap, so staging width is
    the lever that matters there.

    Raw capture bytes pass through the ``source.parse`` fault site
    (``fault_data``) before decode, so the corrupt-input fault kinds
    (``corrupt_bytes``/``truncate``/``ragged``) exercise the binary
    parsers' bounds-checked salvage exactly like the CSV path's."""

    #: the capture format decoded (``netflow`` or ``pcap``)
    format = "netflow"

    def _decode_file(self, data: bytes) -> Frame:
        raise NotImplementedError

    def parser(self) -> str:
        """Which parser decodes the captures: ``native`` (the C++
        library) or ``python`` (no ``g++``: the fallback parser)."""
        from sntc_tpu_torch.native import using_native, using_native_pcap

        native = (using_native() if self.format == "netflow"
                  else using_native_pcap())
        return "native" if native else "python"

    def _load_file(self, path: str) -> Frame:
        with open(path, "rb") as f:
            data = f.read()
        labels = {} if self.tenant is None else {"tenant": self.tenant}
        inc("sntc_ingest_bytes_read_total", len(data), **labels)
        return self._decode_file(fault_data("source.parse", data))


def decode_pcap_packets(data: bytes):
    """``parse_pcap`` with THE capture-file serving policy, shared by
    every pcap-serving source (:class:`PcapDirSource`, the flow
    engine's ``FlowCaptureSource``): a short header is a
    partially-written capture (external writer race) — FAILING the
    batch is the lossless choice, the intent stays uncommitted in the
    WAL and the engine replays it next poll when the file is complete
    (writers should rename into place atomically, as ``capture_udp``
    does); ≥24 bytes with a bad magic or unsupported linktype will
    never become readable — retrying would wedge the stream forever,
    so skip it (0 packets) and warn, like Spark's badRecordsPath.
    Returns the ``[n, PCAP_FIELDS]`` packet matrix."""
    import numpy as np

    from sntc_tpu_torch.native import PCAP_FIELDS, parse_pcap

    pkts = parse_pcap(data)
    if pkts is None:
        if len(data) < 24:
            raise ValueError(
                "truncated pcap capture (partial write? writers must "
                "rename into place atomically); batch will be retried"
            )
        warnings.warn(
            "skipping unreadable capture file (bad magic or "
            "unsupported linktype; only Ethernet/raw-IP are decoded)"
        )
        return np.zeros((0, PCAP_FIELDS), np.float64)
    return pkts


class NetFlowDirSource(_CaptureDirSource):
    """Directory of NetFlow v5 capture files (``*.nf5``)."""

    def __init__(self, path: str, pattern: str = "*.nf5", **kwargs):
        super().__init__(path, pattern, **kwargs)

    def _decode_file(self, data: bytes) -> Frame:
        return netflow_to_flow_frame(parse_stream(data))


def _capture_index(path: str) -> int:
    """Sequence index embedded in a capture file name
    (``capture_000042.nf5`` -> 42); non-conforming names count as -1 so
    a foreign file never inflates the resume point."""
    import re

    m = re.search(r"(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def capture_udp(
    port: int,
    out_dir: str,
    max_datagrams: int,
    timeout_s: float = 5.0,
    host: str = "127.0.0.1",
    datagrams_per_file: int = 100,
    sock: Optional[socket.socket] = None,
) -> int:
    """Collect NetFlow datagrams from UDP into capture files (the WAL the
    replayable source reads).  Returns the number of datagrams captured.

    Deprecated-compat path: :class:`sntc_tpu_torch.serve.ingress
    .UdpIngressListener` is the supervised front door (bounded ring,
    counted shed, retention, drain); this blocking helper remains for
    scripts but now shares its durability discipline — capture files
    publish through the fsynced atomic rename (file + containing dir),
    and the sequence index resumes from max-existing-index + 1, so a
    retention-pruned spool never reuses an index and silently
    overwrites a live capture."""
    from sntc_tpu_torch.resilience.storage import atomic_write_bytes

    os.makedirs(out_dir, exist_ok=True)
    own_sock = sock is None
    if own_sock:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind((host, port))
    sock.settimeout(timeout_s)
    captured = 0
    buf: List[bytes] = []
    existing = glob.glob(os.path.join(out_dir, "*.nf5"))
    file_idx = max(
        (_capture_index(p) for p in existing), default=-1
    ) + 1

    def flush():
        nonlocal file_idx, buf
        if buf:
            path = os.path.join(out_dir, f"capture_{file_idx:06d}.nf5")
            atomic_write_bytes(
                path, b"".join(buf), site="ingress.spool"
            )
            file_idx += 1
            buf = []

    try:
        while captured < max_datagrams:
            try:
                data, _ = sock.recvfrom(65_535)
            except socket.timeout:
                break
            buf.append(data)
            captured += 1
            if len(buf) >= datagrams_per_file:
                flush()
    finally:
        flush()
        if own_sock:
            sock.close()
    return captured


class PcapDirSource(_CaptureDirSource):
    """Directory of pcap capture files — the pcap half of [B:11]'s
    "NetFlow/pcap micro-batches".  Each capture file's packets are
    metered into CICIDS2017-schema flows (``native/pcap.py``)."""

    format = "pcap"

    def __init__(
        self,
        path: str,
        pattern: str = "*.pcap",
        flow_timeout: float = 120.0,
        activity_timeout: float = 5.0,
        **kwargs,
    ):
        super().__init__(path, pattern, **kwargs)
        self.flow_timeout = flow_timeout
        self.activity_timeout = activity_timeout

    def _decode_file(self, data: bytes) -> Frame:
        from sntc_tpu_torch.native import packets_to_flow_frame

        return packets_to_flow_frame(
            decode_pcap_packets(data),
            flow_timeout=self.flow_timeout,
            activity_timeout=self.activity_timeout,
        )
