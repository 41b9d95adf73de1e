// NetFlow v5 datagram parser — the native host-ingest component for live
// streaming inference (config 5 [B:11], SURVEY.md §3.5).
//
// Where the reference stack's native layer is OpenBLAS/netty/codec JNI
// (SURVEY.md §2.7), the TPU rebuild's device math is XLA-compiled; the one
// host-side hot path that genuinely wants native code is wire-format
// parsing of live flow telemetry.  This translation unit decodes NetFlow
// v5 export datagrams (24-byte header + N x 48-byte records, all fields
// big-endian) straight into a dense float64 feature matrix consumed
// zero-copy by numpy via ctypes (sntc_tpu_torch/native/netflow.py).
//
// ABI (extern "C", stable):
//   nf5_count(buf, len)  -> record count, or -1 if malformed
//   nf5_parse(buf, len, out, cap) -> records written; `out` is row-major
//       [cap, NF5_FIELDS] float64, one row per record, fields as in
//       kFieldOrder below.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kHeaderBytes = 24;
constexpr int kRecordBytes = 48;
constexpr int kMaxRecordsPerDatagram = 30;  // per the v5 spec

inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

inline uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

}  // namespace

extern "C" {

// Field order of one output row (doubles hold uint32 exactly):
//  0 srcaddr      1 dstaddr      2 srcport    3 dstport
//  4 protocol     5 tcp_flags    6 tos        7 packets
//  8 octets       9 first_ms    10 last_ms   11 input_if
// 12 output_if   13 src_as      14 dst_as    15 duration_ms
constexpr int NF5_FIELDS = 16;

int nf5_fields() { return NF5_FIELDS; }

int nf5_count(const uint8_t* buf, size_t len) {
  if (buf == nullptr || len < kHeaderBytes) return -1;
  if (be16(buf) != 5) return -1;  // version
  const int count = be16(buf + 2);
  if (count < 0 || count > kMaxRecordsPerDatagram) return -1;
  if (len < static_cast<size_t>(kHeaderBytes + count * kRecordBytes))
    return -1;
  return count;
}

int nf5_parse(const uint8_t* buf, size_t len, double* out, int cap) {
  const int count = nf5_count(buf, len);
  if (count < 0 || out == nullptr) return -1;
  const int n = count < cap ? count : cap;
  const uint8_t* rec = buf + kHeaderBytes;
  for (int i = 0; i < n; ++i, rec += kRecordBytes) {
    double* row = out + static_cast<ptrdiff_t>(i) * NF5_FIELDS;
    const uint32_t first = be32(rec + 24);
    const uint32_t last = be32(rec + 28);
    row[0] = be32(rec + 0);    // srcaddr
    row[1] = be32(rec + 4);    // dstaddr
    row[2] = be16(rec + 32);   // srcport
    row[3] = be16(rec + 34);   // dstport
    row[4] = rec[38];          // protocol
    row[5] = rec[37];          // tcp_flags
    row[6] = rec[39];          // tos
    row[7] = be32(rec + 16);   // dPkts
    row[8] = be32(rec + 20);   // dOctets
    row[9] = first;            // sysuptime of flow start (ms)
    row[10] = last;            // sysuptime of flow end (ms)
    row[11] = be16(rec + 12);  // input ifindex
    row[12] = be16(rec + 14);  // output ifindex
    row[13] = be16(rec + 40);  // src_as
    row[14] = be16(rec + 42);  // dst_as
    row[15] = last >= first ? static_cast<double>(last - first) : 0.0;
  }
  return n;
}

// Parse a concatenated stream of datagrams (a capture file): returns total
// records written, advancing datagram-by-datagram; stops at the first
// malformed datagram (returns what was parsed so far).
int nf5_parse_stream(const uint8_t* buf, size_t len, double* out, int cap) {
  size_t off = 0;
  int total = 0;
  while (off + kHeaderBytes <= len && total < cap) {
    const int count = nf5_count(buf + off, len - off);
    if (count < 0) break;
    const int wrote = nf5_parse(
        buf + off, len - off, out + static_cast<ptrdiff_t>(total) * NF5_FIELDS,
        cap - total);
    if (wrote < 0) break;
    total += wrote;
    off += kHeaderBytes + static_cast<size_t>(count) * kRecordBytes;
  }
  return total;
}

}  // extern "C"
