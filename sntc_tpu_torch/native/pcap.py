"""pcap decode and flow metering: the ``ctypes`` binding, the Python
parser, and the CICFlowMeter analog.

Counterpart of ``sntc_tpu/native/pcap.py``, with the same bytes in and
the same float32 features out (the numpy operations in the same order).
See ``pcap.cpp`` beside this file for the capture format and the packet
field order.  ``packets_to_flow_frame`` groups the packet matrix into
bidirectional flows and emits the 78 CICIDS2017 columns
(``data/schema.py``): one lexsort groups packets into flows, and segment
reductions give every statistic, with no loop over flows.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional

import numpy as np

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data.schema import CICIDS2017_FEATURES
from sntc_tpu_torch.native._loader import NativeLib

_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE = NativeLib(os.path.join(_DIR, "pcap.cpp"), "libpcapflow.so")

PCAP_FIELDS = 12
PCAP_FIELD_NAMES = [
    "ts", "src_ip", "dst_ip", "src_port", "dst_port", "protocol",
    "ip_len", "payload_len", "tcp_flags", "tcp_window", "header_len",
    "orig_len",
]
_P = {name: i for i, name in enumerate(PCAP_FIELD_NAMES)}

def _configure(lib: ctypes.CDLL) -> None:
    lib.pcap_ok.restype = ctypes.c_int
    lib.pcap_ok.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.pcap_parse.restype = ctypes.c_int
    lib.pcap_parse.argtypes = [
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

_MAGICS = {
    0xA1B2C3D4: (">", 1e-6),
    0xD4C3B2A1: ("<", 1e-6),
    0xA1B23C4D: (">", 1e-9),
    0x4D3CB2A1: ("<", 1e-9),
}


def _parse_pcap_py(data: bytes) -> Optional[np.ndarray]:
    if len(data) < 24:
        return None
    (magic_be,) = struct.unpack(">I", data[:4])
    if magic_be not in _MAGICS:
        return None
    endian, ts_scale = _MAGICS[magic_be]
    (linktype,) = struct.unpack(endian + "I", data[20:24])
    if linktype not in (1, 101):
        return None
    rows = []
    off = 24
    rec = struct.Struct(endian + "IIII")
    while off + 16 <= len(data):
        ts_sec, ts_frac, incl, orig = rec.unpack(data[off : off + 16])
        off += 16
        if incl > len(data) - off:
            break
        pkt = data[off : off + incl]
        off += incl
        ip_off = 0
        if linktype == 1:
            if incl < 14:
                continue
            ethertype = struct.unpack(">H", pkt[12:14])[0]
            ip_off = 14
            if ethertype == 0x8100:
                if incl < 18:
                    continue
                ethertype = struct.unpack(">H", pkt[16:18])[0]
                ip_off = 18
            if ethertype != 0x0800:
                continue
        if incl < ip_off + 20:
            continue
        ip = pkt[ip_off:]
        if (ip[0] >> 4) != 4:
            continue
        ihl = (ip[0] & 0x0F) * 4
        if ihl < 20 or incl < ip_off + ihl:
            continue
        ip_total = struct.unpack(">H", ip[2:4])[0]
        proto = ip[9]
        src = struct.unpack(">I", ip[12:16])[0]
        dst = struct.unpack(">I", ip[16:20])[0]
        l4 = ip[ihl:]
        sport = dport = flags = window = 0
        if proto == 6:
            if len(l4) < 20:
                continue
            sport, dport = struct.unpack(">HH", l4[:4])
            l4_hdr = (l4[12] >> 4) * 4
            if l4_hdr < 20 or len(l4) < l4_hdr:
                continue
            flags = l4[13]
            window = struct.unpack(">H", l4[14:16])[0]
        elif proto == 17:
            if len(l4) < 8:
                continue
            sport, dport = struct.unpack(">HH", l4[:4])
            l4_hdr = 8
        else:
            continue
        payload = max(ip_total - ihl - l4_hdr, 0)
        rows.append([
            ts_sec + ts_frac * ts_scale, src, dst, sport, dport, proto,
            ip_total, payload, flags, window, ihl + l4_hdr, orig,
        ])
    if not rows:
        return np.zeros((0, PCAP_FIELDS), np.float64)
    return np.asarray(rows, np.float64)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def scan_truncation(data: bytes) -> tuple:
    """Bounds-check the capture's record framing WITHOUT parsing packet
    bodies: returns ``(clean_len, dropped_bytes)`` where
    ``data[:clean_len]`` is the longest prefix made of complete records
    and ``dropped_bytes`` is the torn tail (0 = clean capture).  A
    header too short/bad to carry records reports the whole payload as
    clean (the parser's bad-header path owns that verdict)."""
    if len(data) < 24:
        return len(data), 0
    (magic_be,) = struct.unpack(">I", data[:4])
    if magic_be not in _MAGICS:
        return len(data), 0
    endian, _ = _MAGICS[magic_be]
    off = 24
    n = len(data)
    rec = struct.Struct(endian + "IIII")
    while off + 16 <= n:
        incl = rec.unpack_from(data, off)[2]
        if off + 16 + incl > n:
            break  # record header promises more bytes than exist
        off += 16 + incl
    return off, n - off


def parse_pcap(data: bytes) -> Optional[np.ndarray]:
    """Capture bytes -> ``[n, PCAP_FIELDS]`` float64 packet matrix
    (IPv4 TCP/UDP packets only), or None if the global header is bad.

    A capture torn mid-record (partial write, corrupt length field)
    does NOT raise and is never silently absorbed either: the longest
    complete-record prefix parses normally and the dropped tail is
    reported as a structured ``parse_truncated`` event on the
    ``source.parse`` site — the row-granular salvage contract applied
    at the byte level (docs/RESILIENCE.md "Data-plane admission").

    The output buffer is sized from the data itself (every packet record
    costs at least 16 header bytes), so small micro-batch captures stay
    cheap and large ones are never truncated.
    """
    clean_len, dropped = scan_truncation(data)
    if dropped:
        from sntc_tpu_torch.resilience import emit_event

        emit_event(
            event="parse_truncated", site="source.parse", format="pcap",
            valid_bytes=clean_len, dropped_bytes=dropped,
        )
        data = data[:clean_len]
    lib = _get_lib()
    if lib is None:
        return _parse_pcap_py(data)
    if not lib.pcap_ok(data, len(data)):
        return None
    cap = max((len(data) - 24) // 16, 1)
    out = np.zeros((cap, PCAP_FIELDS), np.float64)
    wrote = lib.pcap_parse(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
    )
    if wrote < 0:
        return None
    return out[:wrote].copy()


def make_pcap(packets, linktype: int = 1, nanos: bool = False) -> bytes:
    """Encode packets into a classic pcap byte string — the test/demo
    capture writer.  ``packets`` is a sequence of ``(ts, bytes)``."""
    magic = 0xA1B23C4D if nanos else 0xA1B2C3D4
    scale = 1e9 if nanos else 1e6
    head = struct.pack(">IHHiIII", magic, 2, 4, 0, 0, 65535, linktype)
    parts = [head]
    for ts, pkt in packets:
        sec = int(ts)
        frac = int(round((ts - sec) * scale))
        parts.append(struct.pack(">IIII", sec, frac, len(pkt), len(pkt)))
        parts.append(pkt)
    # one join: linear in the capture's size (the JAX writer's
    # ``body +=`` copies the body once a packet, the same bytes)
    return b"".join(parts)


def make_packet(
    src: int, dst: int, sport: int, dport: int, proto: int = 6,
    payload: int = 100, flags: int = 0x18, window: int = 8192,
) -> bytes:
    """Build one Ethernet+IPv4+TCP/UDP packet with ``payload`` data bytes
    (zeros) — the synthetic traffic generator for tests/demos."""
    l4_hdr = 20 if proto == 6 else 8
    ip_total = 20 + l4_hdr + payload
    eth = b"\x02" * 6 + b"\x04" * 6 + struct.pack(">H", 0x0800)
    ip = struct.pack(
        ">BBHHHBBHII", 0x45, 0, ip_total, 0, 0, 64, proto, 0, src, dst
    )
    if proto == 6:
        l4 = struct.pack(
            ">HHIIBBHHH", sport, dport, 0, 0, 5 << 4, flags, window, 0, 0
        )
    else:
        l4 = struct.pack(">HHHH", sport, dport, 8 + payload, 0)
    return eth + ip + l4 + b"\x00" * payload


# ---------------------------------------------------------------------------
# the flow meter (CICFlowMeter analog)
# ---------------------------------------------------------------------------


def _seg_stat(values, starts, counts):
    """(sum, mean, std, min, max) per segment of a sorted-by-segment
    vector, via reduceat — no Python loop."""
    sums = np.add.reduceat(values, starts) if len(values) else np.zeros(0)
    sums = np.where(counts > 0, sums, 0.0)
    mean = sums / np.maximum(counts, 1)
    sq = np.add.reduceat(values * values, starts) if len(values) else np.zeros(0)
    sq = np.where(counts > 0, sq, 0.0)
    var = np.maximum(sq / np.maximum(counts, 1) - mean * mean, 0.0)
    # CICFlowMeter reports the SAMPLE std (n-1); guard n<=1 -> 0
    var = np.where(counts > 1, var * counts / np.maximum(counts - 1, 1), 0.0)
    mins = np.minimum.reduceat(values, starts) if len(values) else np.zeros(0)
    maxs = np.maximum.reduceat(values, starts) if len(values) else np.zeros(0)
    mins = np.where(counts > 0, mins, 0.0)
    maxs = np.where(counts > 0, maxs, 0.0)
    return sums, mean, np.sqrt(var), mins, maxs


def _masked_seg_stat(values, mask, seg_ids, n_seg):
    """Per-segment (sum, mean, std, min, max) over only ``mask`` rows
    (fwd/bwd direction splits); segments with no selected rows -> 0."""
    sel = np.flatnonzero(mask)
    v = values[sel]
    s = seg_ids[sel]
    counts = np.bincount(s, minlength=n_seg).astype(np.float64)
    sums = np.bincount(s, weights=v, minlength=n_seg)
    mean = sums / np.maximum(counts, 1)
    sq = np.bincount(s, weights=v * v, minlength=n_seg)
    var = np.maximum(sq / np.maximum(counts, 1) - mean * mean, 0.0)
    var = np.where(counts > 1, var * counts / np.maximum(counts - 1, 1), 0.0)
    mins = np.full(n_seg, np.inf)
    maxs = np.full(n_seg, -np.inf)
    np.minimum.at(mins, s, v)
    np.maximum.at(maxs, s, v)
    mins = np.where(counts > 0, mins, 0.0)
    maxs = np.where(counts > 0, maxs, 0.0)
    return counts, sums, mean, np.sqrt(var), mins, maxs


def packets_to_flow_frame(
    pkts: np.ndarray,
    flow_timeout: float = 120.0,
    activity_timeout: float = 5.0,
) -> Frame:
    """``[n, PCAP_FIELDS]`` packets -> 78-column CICIDS2017-schema Frame.

    Flow identity is the bidirectional 5-tuple; a quiet gap longer than
    ``flow_timeout`` starts a new flow (CICFlowMeter's timeout split).
    The forward direction is the direction of each flow's first packet.
    ``Active``/``Idle`` statistics split each flow at gaps longer than
    ``activity_timeout``.  Features pcap genuinely cannot produce (bulk
    rates) stay 0 — CICFlowMeter itself emits 0 for them on CICIDS2017.
    """
    n = pkts.shape[0]
    if n == 0:
        return Frame({name: np.zeros(0, np.float32) for name in CICIDS2017_FEATURES})

    ts = pkts[:, _P["ts"]]
    src = pkts[:, _P["src_ip"]].astype(np.int64)
    dst = pkts[:, _P["dst_ip"]].astype(np.int64)
    sport = pkts[:, _P["src_port"]].astype(np.int64)
    dport = pkts[:, _P["dst_port"]].astype(np.int64)
    proto = pkts[:, _P["protocol"]].astype(np.int64)
    paylen = pkts[:, _P["payload_len"]]
    flags = pkts[:, _P["tcp_flags"]].astype(np.int64)
    window = pkts[:, _P["tcp_window"]]
    hdrlen = pkts[:, _P["header_len"]]

    # canonical (order-free) endpoint key + direction bit
    ep_a = src * 65536 + sport
    ep_b = dst * 65536 + dport
    lo = np.minimum(ep_a, ep_b)
    hi = np.maximum(ep_a, ep_b)
    a_is_lo = ep_a <= ep_b  # this packet travels lo -> hi

    # sort by (key, time): flows become contiguous runs
    order = np.lexsort((ts, proto, hi, lo))
    lo_s, hi_s, proto_s, ts_s = lo[order], hi[order], proto[order], ts[order]
    new_key = np.empty(n, bool)
    new_key[0] = True
    new_key[1:] = (
        (lo_s[1:] != lo_s[:-1])
        | (hi_s[1:] != hi_s[:-1])
        | (proto_s[1:] != proto_s[:-1])
    )
    gap = np.empty(n, np.float64)
    gap[0] = 0.0
    gap[1:] = ts_s[1:] - ts_s[:-1]
    # a new FLOW starts at a new 5-tuple or after a long quiet gap
    new_flow = new_key | (gap > flow_timeout)
    seg_ids = np.cumsum(new_flow) - 1
    n_seg = int(seg_ids[-1]) + 1
    starts = np.flatnonzero(new_flow)
    counts = np.diff(np.append(starts, n)).astype(np.float64)

    # forward = direction of the flow's first packet
    a_lo_s = a_is_lo[order]
    first_dir = a_lo_s[starts]  # per segment
    fwd = a_lo_s == first_dir[seg_ids]
    bwd = ~fwd

    pay_s = paylen[order]
    hdr_s = hdrlen[order]
    flags_s = flags[order]
    win_s = window[order]
    dport_pkt = dport[order]

    dur = ts_s[np.append(starts[1:], n) - 1] - ts_s[starts]  # per segment, s
    dur_us = dur * 1e6
    dur_s_safe = np.maximum(dur, 1e-9)

    f_cnt, f_sum, f_mean, f_std, f_min, f_max = _masked_seg_stat(
        pay_s, fwd, seg_ids, n_seg
    )
    b_cnt, b_sum, b_mean, b_std, b_min, b_max = _masked_seg_stat(
        pay_s, bwd, seg_ids, n_seg
    )
    a_sum, a_mean, a_std, a_min, a_max = _seg_stat(pay_s, starts, counts)

    # inter-arrival times: within-flow diffs (flow IAT), and per-direction
    iat = np.where(new_flow, np.nan, gap) * 1e6  # µs; NaN marks flow starts
    valid_iat = ~np.isnan(iat)
    fi_cnt, fi_sum, fi_mean, fi_std, fi_min, fi_max = _masked_seg_stat(
        np.nan_to_num(iat), valid_iat, seg_ids, n_seg
    )
    # per-direction IATs need per-direction previous timestamps: compute by
    # sorting the direction subsets (they are already time-ordered)
    def dir_iat(mask):
        sel = np.flatnonzero(mask)
        t = ts_s[sel]
        s = seg_ids[sel]
        first = np.empty(len(sel), bool)
        if len(sel):
            first[0] = True
            first[1:] = s[1:] != s[:-1]
        d = np.empty(len(sel), np.float64)
        if len(sel):
            d[0] = 0.0
            d[1:] = (t[1:] - t[:-1]) * 1e6
        ok = ~first
        cnt, ssum, mean, std, mn, mx = _masked_seg_stat(d, ok, s, n_seg)
        return ssum, mean, std, mn, mx

    ffi_sum, ffi_mean, ffi_std, ffi_min, ffi_max = dir_iat(fwd)
    bfi_sum, bfi_mean, bfi_std, bfi_min, bfi_max = dir_iat(bwd)

    # ACTIVE/IDLE: split each flow at gaps > activity_timeout; idle = those
    # gaps, active = span durations between them
    idle_gap = valid_iat & (gap > activity_timeout)
    _, _, id_mean, id_std, id_min, id_max = _masked_seg_stat(
        gap * 1e6, idle_gap, seg_ids, n_seg
    )
    # active spans: sub-segment boundaries at flow starts OR idle gaps
    new_span = new_flow | idle_gap
    span_starts = np.flatnonzero(new_span)
    span_seg = seg_ids[span_starts]
    span_end = np.append(span_starts[1:], n) - 1
    span_dur = (ts_s[span_end] - ts_s[span_starts]) * 1e6
    ac_cnt, ac_sum, ac_mean, ac_std, ac_min, ac_max = _masked_seg_stat(
        span_dur, np.ones(len(span_dur), bool), span_seg, n_seg
    )

    # per-direction flag counts and header sums; mask=None means all rows
    def dir_count(mask, bit=None, weights=None):
        if bit is None:
            sel = mask
        else:
            sel = (flags_s & bit) > 0
            if mask is not None:
                sel = mask & sel
        if weights is None:
            return np.bincount(
                seg_ids[sel], minlength=n_seg
            ).astype(np.float64)
        return np.bincount(seg_ids[sel], weights=weights[sel], minlength=n_seg)

    # init window bytes: value of the first packet per direction
    def first_per_dir(mask, values):
        sel = np.flatnonzero(mask)
        s = seg_ids[sel]
        first = np.empty(len(sel), bool)
        if len(sel):
            first[0] = True
            first[1:] = s[1:] != s[:-1]
        out = np.full(n_seg, -1.0)
        out[s[first]] = values[sel][first]
        return out

    cols = {name: np.zeros(n_seg, np.float32) for name in CICIDS2017_FEATURES}

    def put(name, v):
        cols[name] = np.asarray(v, np.float32)

    # the flow's destination port is the first packet's dst port
    put("Destination Port", dport_pkt[starts])
    put("Flow Duration", dur_us)
    put("Total Fwd Packets", f_cnt)
    put("Total Backward Packets", b_cnt)
    put("Total Length of Fwd Packets", f_sum)
    put("Total Length of Bwd Packets", b_sum)
    put("Fwd Packet Length Max", f_max)
    put("Fwd Packet Length Min", f_min)
    put("Fwd Packet Length Mean", f_mean)
    put("Fwd Packet Length Std", f_std)
    put("Bwd Packet Length Max", b_max)
    put("Bwd Packet Length Min", b_min)
    put("Bwd Packet Length Mean", b_mean)
    put("Bwd Packet Length Std", b_std)
    put("Flow Bytes/s", (f_sum + b_sum) / dur_s_safe)
    put("Flow Packets/s", counts / dur_s_safe)
    put("Flow IAT Mean", fi_mean)
    put("Flow IAT Std", fi_std)
    put("Flow IAT Max", fi_max)
    put("Flow IAT Min", fi_min)
    put("Fwd IAT Total", ffi_sum)
    put("Fwd IAT Mean", ffi_mean)
    put("Fwd IAT Std", ffi_std)
    put("Fwd IAT Max", ffi_max)
    put("Fwd IAT Min", ffi_min)
    put("Bwd IAT Total", bfi_sum)
    put("Bwd IAT Mean", bfi_mean)
    put("Bwd IAT Std", bfi_std)
    put("Bwd IAT Max", bfi_max)
    put("Bwd IAT Min", bfi_min)
    put("Fwd PSH Flags", dir_count(fwd, 0x08))
    put("Bwd PSH Flags", dir_count(bwd, 0x08))
    put("Fwd URG Flags", dir_count(fwd, 0x20))
    put("Bwd URG Flags", dir_count(bwd, 0x20))
    put("Fwd Header Length", dir_count(fwd, weights=hdr_s))
    put("Bwd Header Length", dir_count(bwd, weights=hdr_s))
    put("Fwd Packets/s", f_cnt / dur_s_safe)
    put("Bwd Packets/s", b_cnt / dur_s_safe)
    put("Min Packet Length", a_min)
    put("Max Packet Length", a_max)
    put("Packet Length Mean", a_mean)
    put("Packet Length Std", a_std)
    put("Packet Length Variance", a_std**2)
    for bit, name in (
        (0x01, "FIN Flag Count"), (0x02, "SYN Flag Count"),
        (0x04, "RST Flag Count"), (0x08, "PSH Flag Count"),
        (0x10, "ACK Flag Count"), (0x20, "URG Flag Count"),
        (0x80, "CWE Flag Count"), (0x40, "ECE Flag Count"),
    ):
        put(name, dir_count(None, bit))
    put("Down/Up Ratio", np.floor(b_cnt / np.maximum(f_cnt, 1.0)))
    put("Average Packet Size", a_mean)
    put("Avg Fwd Segment Size", f_mean)
    put("Avg Bwd Segment Size", b_mean)
    put("Fwd Header Length.1", cols["Fwd Header Length"])
    put("Subflow Fwd Packets", f_cnt)
    put("Subflow Fwd Bytes", f_sum)
    put("Subflow Bwd Packets", b_cnt)
    put("Subflow Bwd Bytes", b_sum)
    put("Init_Win_bytes_forward", first_per_dir(fwd, win_s))
    put("Init_Win_bytes_backward", first_per_dir(bwd, win_s))
    put("act_data_pkt_fwd", dir_count(fwd & (pay_s > 0)))
    min_seg = np.where(
        f_cnt > 0,
        _masked_seg_stat(hdr_s, fwd, seg_ids, n_seg)[4],
        0.0,
    )
    put("min_seg_size_forward", min_seg)
    put("Active Mean", ac_mean)
    put("Active Std", ac_std)
    put("Active Max", ac_max)
    put("Active Min", ac_min)
    put("Idle Mean", id_mean)
    put("Idle Std", id_std)
    put("Idle Max", id_max)
    put("Idle Min", id_min)
    return Frame(cols)


def pcap_to_flow_frame(data: bytes, **kwargs) -> Frame:
    """Capture bytes -> flow-feature Frame (parse + meter in one call)."""
    pkts = parse_pcap(data)
    if pkts is None:
        raise ValueError("not a pcap capture (bad global header)")
    return packets_to_flow_frame(pkts, **kwargs)
