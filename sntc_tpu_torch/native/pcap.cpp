// pcap packet parser — the native host-ingest component for live packet
// capture inference (config 5 [B:11] names "NetFlow/pcap micro-batches";
// SURVEY.md §3.5).  The NetFlow half lives in netflow.cpp; this unit
// decodes classic libpcap capture files (the format CICIDS2017's own
// captures ship in) into a dense per-packet float64 matrix.  Flow
// aggregation into the 78-column CICIDS2017 schema happens vectorized in
// numpy (sntc_tpu_torch/native/pcap.py) — the byte-level packet walk is the
// part Python is slow at, so only that is native.
//
// Format: 24-byte global header (magic 0xa1b2c3d4 / 0xd4c3b2a1 swapped,
// 0xa1b23c4d / 0x4d3cb2a1 for nanosecond variants), then per packet a
// 16-byte record header (ts_sec, ts_frac, incl_len, orig_len) + data.
// Linktype must be 1 (Ethernet) or 101 (raw IP).  Ethernet frames may
// carry one 802.1Q VLAN tag; only IPv4 TCP/UDP packets produce rows
// (others are skipped — the flow meter has no use for them).
//
// ABI (extern "C", stable):
//   pcap_ok(buf, len)                 -> 1 if the global header parses
//   pcap_parse(buf, len, out, cap)   -> rows written, or -1 if malformed;
//       `out` is row-major [cap, PCAP_FIELDS] float64, field order below.

#include <cstddef>
#include <cstdint>

namespace {

inline uint32_t rd32(const uint8_t* p, bool swap) {
  return swap ? (static_cast<uint32_t>(p[3]) << 24) |
                    (static_cast<uint32_t>(p[2]) << 16) |
                    (static_cast<uint32_t>(p[1]) << 8) | p[0]
              : (static_cast<uint32_t>(p[0]) << 24) |
                    (static_cast<uint32_t>(p[1]) << 16) |
                    (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

// network byte order helpers for packet payloads (always big-endian)
inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}
inline uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

struct GlobalHeader {
  bool ok;
  bool swap;       // file byte order != big-endian network order reader
  double ts_scale; // fractional part unit: 1e-6 (µs) or 1e-9 (ns)
  uint32_t linktype;
};

GlobalHeader read_global(const uint8_t* buf, size_t len) {
  GlobalHeader g{false, false, 1e-6, 0};
  if (buf == nullptr || len < 24) return g;
  const uint32_t magic_be = be32(buf);
  switch (magic_be) {
    case 0xa1b2c3d4: g.swap = false; g.ts_scale = 1e-6; break;
    case 0xd4c3b2a1: g.swap = true;  g.ts_scale = 1e-6; break;
    case 0xa1b23c4d: g.swap = false; g.ts_scale = 1e-9; break;
    case 0x4d3cb2a1: g.swap = true;  g.ts_scale = 1e-9; break;
    default: return g;
  }
  g.linktype = rd32(buf + 20, g.swap);
  g.ok = (g.linktype == 1 || g.linktype == 101);
  return g;
}

}  // namespace

extern "C" {

// Field order of one output row:
//  0 ts (seconds, f64)  1 src_ip   2 dst_ip    3 src_port  4 dst_port
//  5 protocol           6 ip_len   7 payload_len (L4 payload bytes)
//  8 tcp_flags          9 tcp_window  10 header_len (IP+L4 headers)
// 11 orig_len (wire bytes incl. link layer)
constexpr int PCAP_FIELDS = 12;

int pcap_fields() { return PCAP_FIELDS; }

int pcap_ok(const uint8_t* buf, size_t len) {
  return read_global(buf, len).ok ? 1 : 0;
}

int pcap_parse(const uint8_t* buf, size_t len, double* out, int cap) {
  const GlobalHeader g = read_global(buf, len);
  if (!g.ok || out == nullptr) return -1;
  size_t off = 24;
  int n = 0;
  while (off + 16 <= len && n < cap) {
    const uint32_t ts_sec = rd32(buf + off, g.swap);
    const uint32_t ts_frac = rd32(buf + off + 4, g.swap);
    const uint32_t incl = rd32(buf + off + 8, g.swap);
    const uint32_t orig = rd32(buf + off + 12, g.swap);
    off += 16;
    if (incl > len - off) break;  // truncated capture tail
    const uint8_t* pkt = buf + off;
    off += incl;

    // ---- link layer -> start of IPv4 ----
    size_t ip_off = 0;
    if (g.linktype == 1) {  // Ethernet
      if (incl < 14) continue;
      uint16_t ethertype = be16(pkt + 12);
      ip_off = 14;
      if (ethertype == 0x8100) {  // one 802.1Q tag
        if (incl < 18) continue;
        ethertype = be16(pkt + 16);
        ip_off = 18;
      }
      if (ethertype != 0x0800) continue;  // not IPv4
    }
    if (incl < ip_off + 20) continue;
    const uint8_t* ip = pkt + ip_off;
    if ((ip[0] >> 4) != 4) continue;  // IPv4 only
    const size_t ihl = static_cast<size_t>(ip[0] & 0x0f) * 4;
    if (ihl < 20 || incl < ip_off + ihl) continue;
    const uint16_t ip_total = be16(ip + 2);
    const uint8_t proto = ip[9];
    const uint32_t src = be32(ip + 12);
    const uint32_t dst = be32(ip + 16);

    const uint8_t* l4 = ip + ihl;
    const size_t l4_avail = incl - ip_off - ihl;
    double sport = 0, dport = 0, flags = 0, window = 0;
    size_t l4_hdr = 0;
    if (proto == 6) {  // TCP
      if (l4_avail < 20) continue;
      sport = be16(l4);
      dport = be16(l4 + 2);
      l4_hdr = static_cast<size_t>(l4[12] >> 4) * 4;
      if (l4_hdr < 20 || l4_avail < l4_hdr) continue;
      flags = l4[13];
      window = be16(l4 + 14);
    } else if (proto == 17) {  // UDP
      if (l4_avail < 8) continue;
      sport = be16(l4);
      dport = be16(l4 + 2);
      l4_hdr = 8;
    } else {
      continue;  // flow meter consumes TCP/UDP only
    }

    const double payload =
        ip_total > ihl + l4_hdr ? static_cast<double>(ip_total - ihl - l4_hdr)
                                : 0.0;
    double* row = out + static_cast<ptrdiff_t>(n) * PCAP_FIELDS;
    row[0] = static_cast<double>(ts_sec) + ts_frac * g.ts_scale;
    row[1] = src;
    row[2] = dst;
    row[3] = sport;
    row[4] = dport;
    row[5] = proto;
    row[6] = ip_total;
    row[7] = payload;
    row[8] = flags;
    row[9] = window;
    row[10] = static_cast<double>(ihl + l4_hdr);
    row[11] = orig;
    ++n;
  }
  return n;
}

}  // extern "C"
