// Segment-log framing + recovery scan — the bus's native hot path.
//
// The port's copy of ccfd_tpu/native/log.cpp, unchanged in behavior: the
// durable bus (ccfd_tpu_torch/bus/log.py) frames and replays its segment
// files through it.
//
// The durable bus persists every record as
//   [u32 payload_len][u32 crc32(payload)][payload]   (little-endian)
// mirroring the role of Kafka's on-disk log segments (the reference's
// de-facto recovery mechanism is Kafka log + committed offsets,
// reference deploy/frauddetection_cr.yaml:73-77; SURVEY.md §5).
//
// C++ carries the two byte-crunching loops:
//   ccfd_log_frame — frame a batch of payloads (CRC + headers) in one pass
//   ccfd_log_scan  — replay scan: validate frames, stop at the first torn
//                    or corrupt frame, report the valid prefix length so
//                    the writer can truncate a crashed tail
// File I/O stays in Python: the ctypes boundary passes plain buffers, so
// there is no FILE*/fd ownership crossing languages.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

// CRC-32 (IEEE 802.3, poly 0xEDB88320) — bit-identical to binascii.crc32,
// which the plain Python version (the tests' reference) uses.
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

inline uint32_t crc32(const uint8_t* data, size_t len) {
  if (!crc_init_done) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i) c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF; p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
}

inline uint32_t get_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

}  // namespace

extern "C" {

uint32_t ccfd_crc32(const uint8_t* data, size_t len) { return crc32(data, len); }

// Frame `n` payloads (concatenated in `payloads`, lengths in `lens`) into
// `out`. `out` must hold sum(lens) + 8*n bytes. Returns bytes written.
size_t ccfd_log_frame(const uint8_t* payloads, const uint32_t* lens, int n,
                      uint8_t* out) {
  size_t in_off = 0, out_off = 0;
  for (int i = 0; i < n; ++i) {
    uint32_t len = lens[i];
    put_u32(out + out_off, len);
    put_u32(out + out_off + 4, crc32(payloads + in_off, len));
    std::memcpy(out + out_off + 8, payloads + in_off, len);
    in_off += len;
    out_off += len + 8;
  }
  return out_off;
}

// Scan up to `max_records` frames from `buf`. Writes each payload's offset
// (into buf) and length. Sets *consumed to the end of the last valid frame
// seen in THIS call. Returns the number of valid records on a clean stop
// (EOF, partial tail, or max_records reached); on corruption (bad CRC or
// insane length) returns -(valid_records + 1) so the caller still learns
// how many leading frames of this call were good.
int ccfd_log_scan(const uint8_t* buf, size_t len, uint64_t* out_off,
                  uint32_t* out_len, int max_records, size_t* consumed) {
  size_t pos = 0;
  int n = 0;
  *consumed = 0;
  while (n < max_records) {
    if (pos + 8 > len) break;  // clean truncation (partial header)
    uint32_t plen = get_u32(buf + pos);
    uint32_t want = get_u32(buf + pos + 4);
    if (plen > (1u << 30)) { *consumed = pos; return -(n + 1); }
    if (pos + 8 + plen > len) break;  // torn tail: frame extends past EOF
    if (crc32(buf + pos + 8, plen) != want) { *consumed = pos; return -(n + 1); }
    out_off[n] = pos + 8;
    out_len[n] = plen;
    pos += 8 + (size_t)plen;
    ++n;
  }
  *consumed = pos;
  return n;
}

}  // extern "C"
