"""NetFlow v5 decode: the ``ctypes`` binding, the Python parser and the
mapping onto the flow schema.

Counterpart of ``sntc_tpu/native/netflow.py``, with the same bytes in
and the same float32 features out.  See ``netflow.cpp`` beside this file
for the wire format and the field order.  ``netflow_to_flow_frame``
lifts parsed records into the 78 CICIDS2017 columns, so a trained
pipeline serves live NetFlow directly; fields that NetFlow v5 does not
carry are 0, and flag "counts" are presence bits.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data.schema import CICIDS2017_FEATURES
from sntc_tpu_torch.native._loader import NativeLib

_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE = NativeLib(os.path.join(_DIR, "netflow.cpp"), "libnetflow.so")

NF5_FIELDS = 16
NF5_FIELD_NAMES = [
    "srcaddr", "dstaddr", "srcport", "dstport",
    "protocol", "tcp_flags", "tos", "packets",
    "octets", "first_ms", "last_ms", "input_if",
    "output_if", "src_as", "dst_as", "duration_ms",
]

_HEADER = struct.Struct(">HHIIIIBBH")  # 24 bytes
_RECORD = struct.Struct(">IIIHHIIIIHHBBBBHHBBH")  # 48 bytes

def _configure(lib: ctypes.CDLL) -> None:
    for name in ("nf5_count", "nf5_parse", "nf5_parse_stream"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
    lib.nf5_count.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    for name in ("nf5_parse", "nf5_parse_stream"):
        getattr(lib, name).argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]


def _get_lib() -> Optional[ctypes.CDLL]:
    return _NATIVE.get(_configure)


def using_native() -> bool:
    return _get_lib() is not None


# ---------------------------------------------------------------------------
# pure-Python fallback (also the test oracle)
# ---------------------------------------------------------------------------


def _parse_py(data: bytes) -> Optional[np.ndarray]:
    if len(data) < 24:
        return None
    version, count = struct.unpack(">HH", data[:4])
    if version != 5 or count > 30 or len(data) < 24 + count * 48:
        return None
    out = np.zeros((count, NF5_FIELDS), np.float64)
    for i in range(count):
        rec = data[24 + i * 48 : 24 + (i + 1) * 48]
        (srcaddr, dstaddr, _nexthop, input_if, output_if, pkts, octets,
         first, last, srcport, dstport, _pad1, flags, proto, tos,
         src_as, dst_as, _smask, _dmask, _pad2) = _RECORD.unpack(rec)
        out[i] = [
            srcaddr, dstaddr, srcport, dstport, proto, flags, tos, pkts,
            octets, first, last, input_if, output_if, src_as, dst_as,
            max(last - first, 0),
        ]
    return out


def _parse_stream_py(data: bytes) -> np.ndarray:
    rows: List[np.ndarray] = []
    off = 0
    while off + 24 <= len(data):
        parsed = _parse_py(data[off:])
        if parsed is None:
            break
        rows.append(parsed)
        off += 24 + parsed.shape[0] * 48
    if not rows:
        return np.zeros((0, NF5_FIELDS), np.float64)
    return np.concatenate(rows, axis=0)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _emit_truncated(reason: str, valid_bytes: int, dropped: int) -> None:
    from sntc_tpu_torch.resilience import emit_event

    emit_event(
        event="parse_truncated", site="source.parse", format="netflow",
        reason=reason, valid_bytes=valid_bytes, dropped_bytes=dropped,
    )


def scan_stream(data: bytes) -> tuple:
    """Bounds-check a concatenated-datagram stream: returns
    ``(clean_len, reason)`` where ``data[:clean_len]`` is the longest
    prefix of complete datagrams and ``reason`` is ``None`` (clean),
    ``"truncated"`` (tail cut mid-datagram) or ``"bad_header"``
    (mid-stream bytes that are not a v5 header — corruption)."""
    off, n = 0, len(data)
    while off + 24 <= n:
        version, count = struct.unpack(">HH", data[off : off + 4])
        if version != 5 or count > 30:
            return off, "bad_header"
        end = off + 24 + count * 48
        if end > n:
            return off, "truncated"
        off = end
    if off < n:
        return off, "truncated"
    return off, None


def parse_datagram(data: bytes) -> Optional[np.ndarray]:
    """One datagram -> [count, NF5_FIELDS] float64, or None if malformed.

    A datagram whose header is sound but whose body was cut short
    (partial capture write) salvages the records that fully fit — the
    valid prefix parses, the torn tail is reported as a structured
    ``parse_truncated`` event instead of failing the whole datagram."""
    if len(data) >= 24:
        version, count = struct.unpack(">HH", data[:4])
        want = 24 + count * 48
        if version == 5 and count <= 30 and len(data) < want:
            n_fit = (len(data) - 24) // 48
            clean = 24 + n_fit * 48
            _emit_truncated("truncated", clean, len(data) - clean)
            # re-frame the valid prefix so both parsers see a
            # self-consistent datagram (header count must match body)
            data = (
                data[:2] + struct.pack(">H", n_fit) + data[4:24]
                + data[24:clean]
            )
    lib = _get_lib()
    if lib is None:
        return _parse_py(data)
    count = lib.nf5_count(data, len(data))
    if count < 0:
        return None
    out = np.zeros((count, NF5_FIELDS), np.float64)
    wrote = lib.nf5_parse(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), count,
    )
    return out[:wrote] if wrote >= 0 else None


def parse_stream(data: bytes, max_records: int = 1_000_000) -> np.ndarray:
    """Concatenated datagrams (a capture file) -> stacked records.

    Bounds-checked: a stream torn mid-datagram, or poisoned mid-stream
    with bytes that are not a v5 header, yields the longest clean
    datagram prefix plus a structured ``parse_truncated`` event naming
    the reason and the dropped byte count — never an exception, never
    a silent stop.  A torn TAIL datagram with a sound header is
    additionally salvaged at record granularity (the records that
    fully fit parse; :func:`parse_datagram` emits the event)."""
    clean_len, reason = scan_stream(data)
    tail_rows: Optional[np.ndarray] = None
    if reason is not None:
        tail = data[clean_len:]
        if reason == "truncated" and len(tail) >= 24:
            tail_rows = parse_datagram(tail)
        else:
            _emit_truncated(reason, clean_len, len(tail))
        data = data[:clean_len]
    lib = _get_lib()
    if lib is None:
        out = _parse_stream_py(data)
    else:
        buf = np.zeros((max_records, NF5_FIELDS), np.float64)
        wrote = lib.nf5_parse_stream(
            data, len(data),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            max_records,
        )
        out = buf[: max(wrote, 0)].copy()
    if tail_rows is not None and tail_rows.shape[0]:
        out = np.concatenate([out, tail_rows], axis=0)
    return out


def make_datagram(
    records: Sequence[Tuple],
    sys_uptime: int = 3_600_000,
    unix_secs: int = 1_700_000_000,
    seq: int = 0,
) -> bytes:
    """Encode records (tuples in NF5_FIELD_NAMES[:15] order, sans duration)
    into a v5 datagram — the test/demo exporter."""
    if len(records) > 30:
        raise ValueError("NetFlow v5 datagrams carry at most 30 records")
    head = _HEADER.pack(5, len(records), sys_uptime, unix_secs, 0, seq, 0, 0, 0)
    parts = [head]
    for r in records:
        (srcaddr, dstaddr, srcport, dstport, proto, flags, tos, pkts,
         octets, first, last, input_if, output_if, src_as, dst_as) = r
        parts.append(_RECORD.pack(
            int(srcaddr), int(dstaddr), 0, int(input_if), int(output_if),
            int(pkts), int(octets), int(first), int(last), int(srcport),
            int(dstport), 0, int(flags), int(proto), int(tos),
            int(src_as), int(dst_as), 0, 0, 0,
        ))
    return b"".join(parts)


_F = {name: i for i, name in enumerate(NF5_FIELD_NAMES)}


def netflow_to_flow_frame(records: np.ndarray) -> Frame:
    """[n, NF5_FIELDS] records -> 78-column CICIDS2017-schema Frame.

    NetFlow v5 is unidirectional and packet-level-blind, so only the
    fields it carries are populated; the rest are 0.  Flag "counts" are
    0/1 presence bits from tcp_flags.
    """
    n = records.shape[0]
    cols = {name: np.zeros(n, np.float32) for name in CICIDS2017_FEATURES}
    r = records

    dur_us = r[:, _F["duration_ms"]] * 1000.0  # CICIDS durations are µs
    dur_s = np.maximum(r[:, _F["duration_ms"]] / 1000.0, 1e-9)
    pkts = r[:, _F["packets"]]
    octets = r[:, _F["octets"]]

    cols["Destination Port"] = r[:, _F["dstport"]].astype(np.float32)
    cols["Flow Duration"] = dur_us.astype(np.float32)
    cols["Total Fwd Packets"] = pkts.astype(np.float32)
    cols["Total Length of Fwd Packets"] = octets.astype(np.float32)
    cols["Flow Bytes/s"] = (octets / dur_s).astype(np.float32)
    cols["Flow Packets/s"] = (pkts / dur_s).astype(np.float32)
    cols["Fwd Packets/s"] = cols["Flow Packets/s"]
    mean_pkt = (octets / np.maximum(pkts, 1.0)).astype(np.float32)
    cols["Average Packet Size"] = mean_pkt
    cols["Packet Length Mean"] = mean_pkt
    cols["Fwd Packet Length Mean"] = mean_pkt
    cols["Avg Fwd Segment Size"] = mean_pkt
    cols["Subflow Fwd Packets"] = pkts.astype(np.float32)
    cols["Subflow Fwd Bytes"] = octets.astype(np.float32)

    flags = r[:, _F["tcp_flags"]].astype(np.int64)
    for bit, name in (
        (0x01, "FIN Flag Count"), (0x02, "SYN Flag Count"),
        (0x04, "RST Flag Count"), (0x08, "PSH Flag Count"),
        (0x10, "ACK Flag Count"), (0x20, "URG Flag Count"),
    ):
        cols[name] = ((flags & bit) > 0).astype(np.float32)
    return Frame(cols)
