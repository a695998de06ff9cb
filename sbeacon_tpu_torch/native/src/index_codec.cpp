// Binary variant-index record codec: the writeDataToS3 / ReadVcfData roles
// (reference: lambda/summariseSlice/source/write_data_to_s3.h:30-228 and
// lambda/duplicateVariantSearch/source/readVcfData.cpp:3-75), rebuilt as one
// symmetric encode/decode pair instead of a write-only half in one lambda
// and a read-only half in another.
//
// Wire format (per record, matching the reference's on-S3 layout):
//   pos      u64 little-endian
//   len      u16 little-endian = |packed_ref| + 1 + |packed_alt|
//   payload  packed_ref '_' packed_alt
// The whole stream is gzip-compressed (zlib, gzip wrapper).
//
// Sequence packing (write_data_to_s3.h compressSeq + generalutils.hpp
// sequenceToBinary): 4-bit codes A=1 C=2 G=3 T=4 N=5 *=6 .=7 (case-
// insensitive), two bases per byte with the FIRST base in the high nibble;
// an odd trailing base occupies the low nibble of its own byte (high
// nibble 0, which is unambiguous because valid codes are >= 1). A
// single-base sequence is one low-nibble byte. Symbolic alleles <...> are
// stored as their raw ASCII contents without the angle brackets.

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

int8_t BaseCode(char c) {
  switch (c) {
    case 'A': case 'a': return 1;
    case 'C': case 'c': return 2;
    case 'G': case 'g': return 3;
    case 'T': case 't': return 4;
    case 'N': case 'n': return 5;
    case '*': return 6;
    case '.': return 7;
    default: return -1;
  }
}

const char kCodeToBase[8] = {'?', 'A', 'C', 'G', 'T', 'N', '*', '.'};

// Append the packed form of seq[0:n] to out. Unknown characters (symbolic
// alleles and anything non-ACGTN*.) pass through raw, brackets stripped.
void PackSeq(const char* s, size_t n, std::string* out) {
  if (n >= 2 && s[0] == '<' && s[n - 1] == '>') {
    out->append(s + 1, n - 2);
    return;
  }
  for (size_t i = 0; i < n; ++i) {
    if (BaseCode(s[i]) < 0) {  // not packable: store raw
      out->append(s, n);
      return;
    }
  }
  if (n == 1) {
    out->push_back(static_cast<char>(BaseCode(s[0])));
    return;
  }
  for (size_t i = 0; i + 1 < n; i += 2) {
    out->push_back(static_cast<char>((BaseCode(s[i]) << 4) |
                                     BaseCode(s[i + 1])));
  }
  if (n % 2) out->push_back(static_cast<char>(BaseCode(s[n - 1])));
}

// Inverse of PackSeq for packed (non-raw) payloads: every byte is either a
// (hi, lo) base pair or a trailing low-nibble single. Returns false when a
// nibble is out of range — the payload was stored raw (symbolic allele).
// HEURISTIC: the format has no raw marker (inherited ambiguity from the
// reference, which never decodes payloads — they are opaque dedupe keys),
// so raw text whose bytes all parse as valid nibble pairs decodes to a
// fabricated sequence. Decoded text is display-only; identity = raw bytes.
bool UnpackSeq(const uint8_t* p, size_t n, std::string* out) {
  for (size_t i = 0; i < n; ++i) {
    uint8_t hi = p[i] >> 4, lo = p[i] & 0xF;
    if (lo == 0 || lo > 7 || hi > 7) return false;
    if (hi == 0) {
      if (i + 1 != n) return false;  // singles only at the end
      out->push_back(kCodeToBase[lo]);
    } else {
      out->push_back(kCodeToBase[hi]);
      out->push_back(kCodeToBase[lo]);
    }
  }
  return true;
}

bool GzipCompress(const std::string& in, int level, std::string* out) {
  z_stream zs{};
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK) {
    return false;
  }
  out->resize(deflateBound(&zs, in.size()) + 32);
  zs.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(in.data()));
  zs.avail_in = in.size();
  zs.next_out = reinterpret_cast<Bytef*>(&(*out)[0]);
  zs.avail_out = out->size();
  int rc = deflate(&zs, Z_FINISH);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return false;
  out->resize(zs.total_out);
  return true;
}

// Inflates ALL concatenated gzip/zlib members in [in, in+in_len).  The
// reference region writer deflates repeatedly into one object whenever the
// 50 MB raw ceiling is hit (write_data_to_s3.h saveOutputToS3), so a single
// region blob may hold several back-to-back gzip members; stopping at the
// first Z_STREAM_END would silently drop every record after it.
bool GzipDecompress(const uint8_t* in, size_t in_len, std::string* out) {
  out->clear();
  const Bytef* next = const_cast<Bytef*>(in);
  size_t remaining = in_len;
  char buf[1 << 16];
  while (remaining > 0) {
    z_stream zs{};
    if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;  // gzip or zlib
    zs.next_in = const_cast<Bytef*>(next);
    zs.avail_in = remaining;
    int rc;
    do {
      zs.next_out = reinterpret_cast<Bytef*>(buf);
      zs.avail_out = sizeof(buf);
      rc = inflate(&zs, Z_NO_FLUSH);
      if (rc != Z_OK && rc != Z_STREAM_END) {
        inflateEnd(&zs);
        return false;  // corrupt member or trailing garbage: error loudly
      }
      out->append(buf, sizeof(buf) - zs.avail_out);
    } while (rc != Z_STREAM_END);
    next = zs.next_in;
    remaining = zs.avail_in;
    inflateEnd(&zs);
  }
  return true;
}

uint8_t* TakeOwnership(const std::string& s) {
  auto* p = static_cast<uint8_t*>(std::malloc(s.size() ? s.size() : 1));
  if (p) std::memcpy(p, s.data(), s.size());
  return p;
}

}  // namespace

extern "C" {

// Encode n records into one gzip blob. refs/alts are concatenated byte
// runs addressed by offsets arrays of n+1 entries. Returns 0 on success;
// *out_p is malloc'd (free with sbn_free).
int sbn_pack_records(uint64_t n, const uint64_t* pos,
                     const uint8_t* ref_bytes, const uint32_t* ref_offsets,
                     const uint8_t* alt_bytes, const uint32_t* alt_offsets,
                     int level, uint8_t** out_p, uint64_t* out_len) {
  std::string raw;
  raw.reserve(n * 16);
  std::string payload;
  for (uint64_t i = 0; i < n; ++i) {
    payload.clear();
    PackSeq(reinterpret_cast<const char*>(ref_bytes) + ref_offsets[i],
            ref_offsets[i + 1] - ref_offsets[i], &payload);
    payload.push_back('_');
    PackSeq(reinterpret_cast<const char*>(alt_bytes) + alt_offsets[i],
            alt_offsets[i + 1] - alt_offsets[i], &payload);
    if (payload.size() > UINT16_MAX) return 3;  // allele too long
    uint64_t p = pos[i];
    uint16_t len = static_cast<uint16_t>(payload.size());
    raw.append(reinterpret_cast<const char*>(&p), sizeof(p));
    raw.append(reinterpret_cast<const char*>(&len), sizeof(len));
    raw.append(payload);
  }
  std::string gz;
  if (!GzipCompress(raw, level, &gz)) return 1;
  *out_p = TakeOwnership(gz);
  if (!*out_p) return 2;
  *out_len = gz.size();
  return 0;
}

// Decode a gzip blob back into records whose pos lies in
// [range_start, range_end] (the ReadVcfData range filter,
// readVcfData.cpp:20-31). Outputs: out_pos (u64[n]), out_payload
// (concatenated packed ref'_'alt runs), out_offsets (u32[n+1]). All
// malloc'd; free each with sbn_free. Returns record count or negative
// error.
int64_t sbn_unpack_records(const uint8_t* blob, uint64_t blob_len,
                           uint64_t range_start, uint64_t range_end,
                           uint64_t** out_pos, uint8_t** out_payload,
                           uint32_t** out_offsets) {
  std::string raw;
  if (!GzipDecompress(blob, blob_len, &raw)) return -1;
  std::vector<uint64_t> positions;
  std::string payloads;
  std::vector<uint32_t> offsets{0};
  size_t i = 0;
  const size_t kHeader = sizeof(uint64_t) + sizeof(uint16_t);
  while (i + kHeader <= raw.size()) {
    uint64_t p;
    uint16_t len;
    std::memcpy(&p, raw.data() + i, sizeof(p));
    std::memcpy(&len, raw.data() + i + sizeof(p), sizeof(len));
    i += kHeader;
    if (i + len > raw.size()) return -2;  // truncated record
    if (range_start <= p && p <= range_end) {
      positions.push_back(p);
      payloads.append(raw.data() + i, len);
      offsets.push_back(static_cast<uint32_t>(payloads.size()));
    }
    i += len;
  }
  if (i != raw.size()) return -2;
  size_t n = positions.size();
  *out_pos = static_cast<uint64_t*>(std::malloc(n ? n * 8 : 8));
  *out_offsets =
      static_cast<uint32_t*>(std::malloc((n + 1) * sizeof(uint32_t)));
  *out_payload = TakeOwnership(payloads);
  if (!*out_pos || !*out_offsets || !*out_payload) return -3;
  std::memcpy(*out_pos, positions.data(), n * 8);
  std::memcpy(*out_offsets, offsets.data(), (n + 1) * sizeof(uint32_t));
  return static_cast<int64_t>(n);
}

// Unpack one packed payload back to sequence text. Returns length written
// (<= cap), or -1 when the payload was stored raw/symbolic (caller keeps
// the raw bytes).
int64_t sbn_unpack_seq(const uint8_t* packed, uint64_t len, uint8_t* out,
                       uint64_t cap) {
  std::string s;
  if (!UnpackSeq(packed, len, &s)) return -1;
  if (s.size() > cap) return -2;
  std::memcpy(out, s.data(), s.size());
  return static_cast<int64_t>(s.size());
}

}  // extern "C"
