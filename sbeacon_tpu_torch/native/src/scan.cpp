// VCF slice scanning: the summariseSlice hot loop, natively.
//
// Native-component parity (SURVEY.md §2.1): re-implements the reference's
// per-record INFO scan (reference: lambda/summariseSlice/source/main.cpp
// addCounts :52-109 — numVariants = 1 + commas of the AC= value, numCalls
// += AN= value, fields walked until both found or the column ends) and the
// branchless ascii->int of shared/generalutils fast_atoi. Operates on
// already-inflated text (sbn_inflate_range's output), so the scan is pure
// byte work with no I/O stalls.

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t FastAtoU64(const char* p, const char* end) {
  uint64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + uint64_t(*p - '0');
    ++p;
  }
  return v;
}

// INFO column begins after the 7th tab of a record line.
inline const char* SeekInfo(const char* p, const char* end) {
  int tabs = 0;
  while (p < end && tabs < 7) {
    if (*p == '\t') ++tabs;
    ++p;
  }
  return tabs == 7 ? p : nullptr;
}

}  // namespace

extern "C" {

// Scan VCF body text: counts via the reference addCounts semantics.
// Header lines ('#') are skipped. Returns 0 on success.
int sbn_count_slice(const uint8_t* text, uint64_t len,
                    int64_t* num_variants, int64_t* num_calls,
                    int64_t* num_records) {
  const char* p = reinterpret_cast<const char*>(text);
  const char* end = p + len;
  int64_t variants = 0, calls = 0, records = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', size_t(end - p)));
    const char* line_end = nl ? nl : end;
    if (p < line_end && *p != '#') {
      ++records;
      const char* q = SeekInfo(p, line_end);
      if (q) {
        bool found_ac = false, found_an = false;
        while (q < line_end && !(found_ac && found_an)) {
          const char* fe = q;
          while (fe < line_end && *fe != ';' && *fe != '\t') ++fe;
          if (fe - q >= 4) {
            if (std::memcmp(q, "AC=", 3) == 0) {
              found_ac = true;
              ++variants;
              for (const char* c = q + 3; c < fe; ++c) {
                if (*c == ',') ++variants;
              }
            } else if (std::memcmp(q, "AN=", 3) == 0) {
              found_an = true;
              calls += int64_t(FastAtoU64(q + 3, fe));
            }
          }
          if (fe >= line_end || *fe == '\t') break;
          q = fe + 1;
        }
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  *num_variants = variants;
  *num_calls = calls;
  *num_records = records;
  return 0;
}

// Newline offsets of non-header lines (record starts), for host-side
// record slicing without re-scanning in Python. out must hold up to
// max_out entries; returns the number written (negative on overflow).
int64_t sbn_line_offsets(const uint8_t* text, uint64_t len, uint64_t* out,
                         uint64_t max_out) {
  const char* base = reinterpret_cast<const char*>(text);
  const char* p = base;
  const char* end = p + len;
  uint64_t n = 0;
  while (p < end) {
    if (*p != '#' && *p != '\n') {
      if (n == max_out) return -1;
      out[n++] = uint64_t(p - base);
    }
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', size_t(end - p)));
    if (!nl) break;
    p = nl + 1;
  }
  return int64_t(n);
}

}  // extern "C"
