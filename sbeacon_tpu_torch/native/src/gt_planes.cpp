// Genotype bit-plane builder: the per-(row, sample) hot loop of index
// construction (the summariseSlice-scan-loop role, reference:
// lambda/summariseSlice/source/main.cpp:230-237 — there the native loop
// counts AC/AN per slice; here it builds the per-row sample-genotype
// planes the selected-samples query path consumes).
//
// Inputs: every used record's GT strings concatenated ('\0'-free runs
// addressed by offsets, record-major then sample), plus per-output-row
// (record index, allele number). Token semantics match the reference's
// get_all_calls regex `[0-9]+` findall (performQuery/search_variants.py:
// 28-29): every digit run in a GT contributes one call.
//
// Outputs (caller-allocated): four uint32 planes [n_rows, words] — bit s
// of word w set when sample s*... has >=1 / >=2 copies of the row's
// allele, >=1 / >=2 GT tokens — plus malloc'd (row, sample, value)
// overflow triples where copies or tokens exceed 2 (ploidy > 2).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

int64_t sbn_gt_planes(
    const uint8_t* gt_blob, const uint64_t* gt_off,  // [n_rec*n_samples+1]
    uint64_t n_rec, uint64_t n_samples,
    const int32_t* row_rec,     // [n_rows] record index per row
    const int32_t* row_allele,  // [n_rows] allele number (alt_ord + 1)
    uint64_t n_rows, uint64_t words,
    uint32_t* gt1, uint32_t* gt2, uint32_t* tok1, uint32_t* tok2,
    int64_t** gt_over_out, uint64_t* n_gt_over,
    int64_t** tok_over_out, uint64_t* n_tok_over) {
  // 1. parse every (record, sample) GT once: digit runs -> tokens, in a
  // flat token array + offsets (two allocations total — a vector per
  // (record, sample) would cost a heap block each at cohort scale)
  const uint64_t n_cells = n_rec * n_samples;
  std::vector<int32_t> tokens;
  tokens.reserve(n_cells * 2);  // diploid common case
  std::vector<uint64_t> tok_off(n_cells + 1, 0);
  for (uint64_t k = 0; k < n_cells; ++k) {
    const uint8_t* s = gt_blob + gt_off[k];
    const uint8_t* e = gt_blob + gt_off[k + 1];
    while (s < e) {
      if (*s >= '0' && *s <= '9') {
        int64_t v = 0;
        while (s < e && *s >= '0' && *s <= '9') {
          v = v * 10 + (*s - '0');
          if (v > INT32_MAX) v = INT32_MAX;  // clamp absurd allele ids
          ++s;
        }
        tokens.push_back(static_cast<int32_t>(v));
      } else {
        ++s;
      }
    }
    tok_off[k + 1] = tokens.size();
  }

  // per-record token-count planes are identical across that record's
  // rows; precompute them (and the token overflow list) once
  std::vector<uint32_t> rec_tok1(n_rec * words, 0);
  std::vector<uint32_t> rec_tok2(n_rec * words, 0);
  std::vector<std::vector<std::pair<int32_t, int32_t>>> rec_tok_over(n_rec);
  for (uint64_t r = 0; r < n_rec; ++r) {
    for (uint64_t s = 0; s < n_samples; ++s) {
      uint64_t k = r * n_samples + s;
      uint64_t nt = tok_off[k + 1] - tok_off[k];
      uint32_t bit = 1u << (s % 32);
      if (nt >= 1) rec_tok1[r * words + s / 32] |= bit;
      if (nt >= 2) rec_tok2[r * words + s / 32] |= bit;
      if (nt > 2) {
        rec_tok_over[r].emplace_back(static_cast<int32_t>(s),
                                     static_cast<int32_t>(nt));
      }
    }
  }

  // 2. fill rows
  std::vector<int64_t> gt_over;
  std::vector<int64_t> tok_over;
  for (uint64_t i = 0; i < n_rows; ++i) {
    int32_t r = row_rec[i];
    int32_t allele = row_allele[i];
    if (r < 0 || static_cast<uint64_t>(r) >= n_rec) return -1;
    std::memcpy(tok1 + i * words, rec_tok1.data() + r * words,
                words * sizeof(uint32_t));
    std::memcpy(tok2 + i * words, rec_tok2.data() + r * words,
                words * sizeof(uint32_t));
    for (const auto& so : rec_tok_over[r]) {
      tok_over.push_back(static_cast<int64_t>(i));
      tok_over.push_back(so.first);
      tok_over.push_back(so.second);
    }
    for (uint64_t s = 0; s < n_samples; ++s) {
      uint64_t k = static_cast<uint64_t>(r) * n_samples + s;
      int32_t copies = 0;
      for (uint64_t t = tok_off[k]; t < tok_off[k + 1]; ++t)
        copies += (tokens[t] == allele);
      if (copies >= 1) {
        uint32_t bit = 1u << (s % 32);
        gt1[i * words + s / 32] |= bit;
        if (copies >= 2) gt2[i * words + s / 32] |= bit;
        if (copies > 2) {
          gt_over.push_back(static_cast<int64_t>(i));
          gt_over.push_back(static_cast<int64_t>(s));
          gt_over.push_back(copies);
        }
      }
    }
  }

  auto take = [](const std::vector<int64_t>& v) -> int64_t* {
    auto* p = static_cast<int64_t*>(
        std::malloc(v.empty() ? 8 : v.size() * sizeof(int64_t)));
    if (p && !v.empty()) {
      std::memcpy(p, v.data(), v.size() * sizeof(int64_t));
    }
    return p;
  };
  *gt_over_out = take(gt_over);
  *tok_over_out = take(tok_over);
  if (!*gt_over_out || !*tok_over_out) return -2;
  *n_gt_over = gt_over.size() / 3;
  *n_tok_over = tok_over.size() / 3;
  return static_cast<int64_t>(n_rows);
}

}  // extern "C"
