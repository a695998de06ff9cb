// VCF record tokenizer: one native pass replacing the per-line Python
// parse (genomics/vcf.parse_record) for the columnar fast path.
//
// Native-component parity (SURVEY.md §2.1): this is the record-header
// walk of the reference's summariseSlice hot loop (reference:
// lambda/summariseSlice/source/main.cpp:230-237 recordHeader + addCounts,
// vcf_chunk_reader.h readPastChars/skipPast byte scanning) generalised to
// emit every field the index build needs as flat arrays: positions, field
// spans (offsets into the caller's text buffer), per-alt spans, INFO
// AC/AN/VT, genotype-derived allele/token tallies (the effective_ac/an
// fallback of genomics/vcf.VcfRecord), and NORMALISED per-sample GT cells
// for the genotype-plane builder (gt_planes.cpp).
//
// Semantics mirror parse_record exactly: lines starting '#' or empty are
// skipped, lines with <8 tab-separated fields are skipped, only '\n' is
// treated as a line terminator (a '\r' stays inside the last field), the
// LAST AC=/AN=/VT= occurrence in INFO wins, and an unparseable AC/AN
// value yields "absent" (python int() -> ValueError -> None).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

template <typename T>
T* CopyOut(const std::vector<T>& v) {
  T* p = static_cast<T*>(std::malloc(v.empty() ? sizeof(T) : v.size() * sizeof(T)));
  if (p && !v.empty()) std::memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

// python int(): optional sign then digits, nothing else. Returns false on
// any deviation (caller treats the field as absent).
inline bool ParseInt(const char* p, const char* end, int64_t* out) {
  if (p >= end) return false;
  bool neg = false;
  if (*p == '+' || *p == '-') {
    neg = (*p == '-');
    ++p;
    if (p >= end) return false;
  }
  int64_t v = 0;
  for (; p < end; ++p) {
    if (*p < '0' || *p > '9') return false;
    if (v > (INT64_MAX - 9) / 10) return false;  // overflow -> "absent"
    v = v * 10 + (*p - '0');
  }
  *out = neg ? -v : v;
  return true;
}

}  // namespace

extern "C" {

int sbn_tokenize(
    const uint8_t* text, uint64_t len, uint64_t n_samples,
    // per-record (n_rec)
    int64_t** pos_out,
    uint32_t** chrom_off_out, uint32_t** chrom_len_out,
    uint32_t** ref_off_out, uint32_t** ref_len_out,
    uint32_t** vt_off_out, uint32_t** vt_len_out,
    int64_t** an_out, uint8_t** has_an_out, uint8_t** has_ac_out,
    int64_t** tok_total_out,
    // flat per-alt (n_alt) + starts (n_rec+1)
    uint32_t** alt_off_out, uint32_t** alt_len_out, uint64_t** alt_start_out,
    int64_t** ac_gt_out,  // genotype tally per alt, aligned with alt_start
    // INFO AC values (n_ac) + starts (n_rec+1)
    int64_t** ac_out, uint64_t** ac_start_out,
    // normalised GT cells: blob + offsets [n_rec*n_samples+1]
    uint8_t** gt_blob_out, uint64_t** gt_off_out,
    uint64_t* n_rec_out, uint64_t* n_alt_out, uint64_t* n_ac_out,
    uint64_t* gt_blob_len_out) {
  const char* base = reinterpret_cast<const char*>(text);
  const char* p = base;
  const char* end = p + len;

  std::vector<int64_t> pos, an, tok_total, ac, ac_gt;
  std::vector<uint32_t> chrom_off, chrom_len, ref_off, ref_len;
  std::vector<uint32_t> vt_off, vt_len, alt_off, alt_len;
  std::vector<uint64_t> alt_start{0}, ac_start{0}, gt_off{0};
  std::vector<uint8_t> has_an, has_ac, gt_blob;
  std::vector<std::pair<uint32_t, uint32_t>> fields;  // reused per line

  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', size_t(end - p)));
    const char* le = nl ? nl : end;
    if (p < le && *p != '#') {
      // split the line on tabs
      fields.clear();
      const char* f = p;
      while (true) {
        const char* t = static_cast<const char*>(
            std::memchr(f, '\t', size_t(le - f)));
        const char* fe = t ? t : le;
        fields.emplace_back(uint32_t(f - base), uint32_t(fe - f));
        if (!t) break;
        f = t + 1;
      }
      if (fields.size() < 8) {
        if (!nl) break;
        p = nl + 1;
        continue;
      }
      int64_t pv;
      const char* ps = base + fields[1].first;
      if (!ParseInt(ps, ps + fields[1].second, &pv)) {
        if (!nl) break;  // malformed POS: skip line (python would raise)
        p = nl + 1;
        continue;
      }
      pos.push_back(pv);
      chrom_off.push_back(fields[0].first);
      chrom_len.push_back(fields[0].second);
      ref_off.push_back(fields[3].first);
      ref_len.push_back(fields[3].second);

      // ALT column -> per-alt spans (split on ',')
      {
        const char* a = base + fields[4].first;
        const char* ae = a + fields[4].second;
        const char* s = a;
        while (true) {
          const char* c = static_cast<const char*>(
              std::memchr(s, ',', size_t(ae - s)));
          const char* se = c ? c : ae;
          alt_off.push_back(uint32_t(s - base));
          alt_len.push_back(uint32_t(se - s));
          if (!c) break;
          s = c + 1;
        }
      }
      const uint64_t rec_alt_begin = alt_start.back();
      alt_start.push_back(alt_len.size());
      const uint64_t rec_n_alts = alt_len.size() - rec_alt_begin;

      // INFO: AC= / AN= / VT=, LAST occurrence wins
      uint8_t h_ac = 0, h_an = 0;
      int64_t an_v = 0;
      uint32_t vt_o = 0, vt_l = 0;
      const uint64_t rec_ac_begin = ac.size();
      {
        const char* q = base + fields[7].first;
        const char* qe = q + fields[7].second;
        while (q < qe) {
          const char* sc = static_cast<const char*>(
              std::memchr(q, ';', size_t(qe - q)));
          const char* fe2 = sc ? sc : qe;
          if (fe2 - q >= 3 && q[2] == '=') {
            if (q[0] == 'A' && q[1] == 'C') {
              ac.resize(rec_ac_begin);  // last AC= wins
              h_ac = 1;
              const char* v = q + 3;
              while (v <= fe2) {
                const char* cm = static_cast<const char*>(
                    std::memchr(v, ',', size_t(fe2 - v)));
                const char* ve = cm ? cm : fe2;
                int64_t cv;
                if (!ParseInt(v, ve, &cv)) {
                  h_ac = 0;  // python: any bad entry -> ac = None
                  ac.resize(rec_ac_begin);
                  break;
                }
                ac.push_back(cv);
                if (!cm) break;
                v = cm + 1;
              }
            } else if (q[0] == 'A' && q[1] == 'N') {
              h_an = ParseInt(q + 3, fe2, &an_v) ? 1 : 0;
            } else if (q[0] == 'V' && q[1] == 'T') {
              vt_o = uint32_t(q + 3 - base);
              vt_l = uint32_t(fe2 - (q + 3));
            }
          }
          if (!sc) break;
          q = sc + 1;
        }
      }
      has_ac.push_back(h_ac);
      has_an.push_back(h_an);
      an.push_back(h_an ? an_v : 0);
      vt_off.push_back(vt_o);
      vt_len.push_back(vt_l);
      ac_start.push_back(ac.size());

      // FORMAT + samples: genotypes only when >9 fields (parse_record)
      int gt_idx = -1;
      if (fields.size() > 9) {
        const char* fm = base + fields[8].first;
        const char* fme = fm + fields[8].second;
        int idx = 0;
        const char* s = fm;
        while (true) {
          const char* c = static_cast<const char*>(
              std::memchr(s, ':', size_t(fme - s)));
          const char* se = c ? c : fme;
          if (se - s == 2 && s[0] == 'G' && s[1] == 'T') {
            gt_idx = idx;
            break;
          }
          if (!c) break;
          s = c + 1;
          ++idx;
        }
      }
      ac_gt.resize(ac_gt.size() + rec_n_alts, 0);
      int64_t* rec_ac_gt = ac_gt.data() + (ac_gt.size() - rec_n_alts);
      int64_t toks = 0;
      uint64_t cells_emitted = 0;
      if (gt_idx >= 0) {
        for (size_t col = 9; col < fields.size(); ++col) {
          // the gt_idx-th ':'-separated piece of this sample column
          const char* s = base + fields[col].first;
          const char* se = s + fields[col].second;
          const char* gs = s;
          int idx = 0;
          const char* ge = nullptr;
          while (idx <= gt_idx) {
            const char* c = static_cast<const char*>(
                std::memchr(gs, ':', size_t(se - gs)));
            if (idx == gt_idx) {
              ge = c ? c : se;
              break;
            }
            if (!c) break;  // fewer pieces than gt_idx: python yields '.'
            gs = c + 1;
            ++idx;
          }
          // token scan over the GT piece (absent piece = '.', tokenless)
          if (ge != nullptr) {
            for (const char* c = gs; c < ge;) {
              if (*c >= '0' && *c <= '9') {
                int64_t v = 0;
                while (c < ge && *c >= '0' && *c <= '9') {
                  if (v < (int64_t(1) << 40))
                    v = v * 10 + (*c - '0');
                  ++c;
                }
                ++toks;
                if (v >= 1 && uint64_t(v) <= rec_n_alts)
                  ++rec_ac_gt[v - 1];
              } else {
                ++c;
              }
            }
          }
          // normalised cell (first n_samples columns only)
          if (cells_emitted < n_samples) {
            if (ge != nullptr) {
              gt_blob.insert(gt_blob.end(),
                             reinterpret_cast<const uint8_t*>(gs),
                             reinterpret_cast<const uint8_t*>(ge));
            }
            gt_off.push_back(gt_blob.size());
            ++cells_emitted;
          }
        }
      }
      while (cells_emitted < n_samples) {  // pad missing cells empty
        gt_off.push_back(gt_blob.size());
        ++cells_emitted;
      }
      tok_total.push_back(toks);
    }
    if (!nl) break;
    p = nl + 1;
  }

  *pos_out = CopyOut(pos);
  *chrom_off_out = CopyOut(chrom_off);
  *chrom_len_out = CopyOut(chrom_len);
  *ref_off_out = CopyOut(ref_off);
  *ref_len_out = CopyOut(ref_len);
  *vt_off_out = CopyOut(vt_off);
  *vt_len_out = CopyOut(vt_len);
  *an_out = CopyOut(an);
  *has_an_out = CopyOut(has_an);
  *has_ac_out = CopyOut(has_ac);
  *tok_total_out = CopyOut(tok_total);
  *alt_off_out = CopyOut(alt_off);
  *alt_len_out = CopyOut(alt_len);
  *alt_start_out = CopyOut(alt_start);
  *ac_gt_out = CopyOut(ac_gt);
  *ac_out = CopyOut(ac);
  *ac_start_out = CopyOut(ac_start);
  *gt_blob_out = CopyOut(gt_blob);
  *gt_off_out = CopyOut(gt_off);
  *n_rec_out = pos.size();
  *n_alt_out = alt_len.size();
  *n_ac_out = ac.size();
  *gt_blob_len_out = gt_blob.size();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused tokenizer + genotype-plane builder (round-4 ingest hot path).
//
// sbn_tokenize walked every sample column to build a normalised GT text
// blob that sbn_gt_planes then re-parsed per (row, sample) — two full
// scans of ~90% of the input bytes plus a blob copy. This single pass
// emits the same record/field arrays AND the four bit planes directly:
// per GT cell the tokens are parsed once into a small buffer, tallied
// against every alt of the record, and the bits written to text-order
// plane rows (the caller reorders rows with one numpy gather, and maps
// the overflow triples the same way). Cell semantics are identical to
// the blob path: digit-run tokens (get_all_calls regex), absent/short
// GT piece = tokenless, columns beyond n_samples still count toward
// tok_total/ac_gt but carry no plane bits.

extern "C" int sbn_tokenize_planes(
    const uint8_t* text, uint64_t len, uint64_t n_samples, uint64_t words,
    int64_t** pos_out,
    uint32_t** chrom_off_out, uint32_t** chrom_len_out,
    uint32_t** ref_off_out, uint32_t** ref_len_out,
    uint32_t** vt_off_out, uint32_t** vt_len_out,
    int64_t** an_out, uint8_t** has_an_out, uint8_t** has_ac_out,
    int64_t** tok_total_out,
    uint32_t** alt_off_out, uint32_t** alt_len_out, uint64_t** alt_start_out,
    int64_t** ac_gt_out,
    int64_t** ac_out, uint64_t** ac_start_out,
    // planes: per flat-alt row (text order) and per record
    uint32_t** g1_out, uint32_t** g2_out,      // [n_alt * words]
    uint32_t** t1_out, uint32_t** t2_out,      // [n_rec * words]
    // overflow triples: (flat_alt_row, sample, copies) / (rec, sample, ntok)
    int64_t** gt_over_out, uint64_t* n_gt_over,
    int64_t** tok_over_out, uint64_t* n_tok_over,
    uint64_t* n_rec_out, uint64_t* n_alt_out, uint64_t* n_ac_out) {
  const char* base = reinterpret_cast<const char*>(text);
  const char* p = base;
  const char* end = p + len;

  std::vector<int64_t> pos, an, tok_total, ac, ac_gt;
  std::vector<uint32_t> chrom_off, chrom_len, ref_off, ref_len;
  std::vector<uint32_t> vt_off, vt_len, alt_off, alt_len;
  std::vector<uint64_t> alt_start{0}, ac_start{0};
  std::vector<uint8_t> has_an, has_ac;
  std::vector<uint32_t> g1, g2, t1, t2;
  std::vector<int64_t> gt_over, tok_over;
  std::vector<int32_t> spill;  // token values beyond the stack buffer

  // reserve from a cheap line estimate (sample-heavy lines are ~10 kB)
  const uint64_t est_rec = len / 512 + 16;
  pos.reserve(est_rec);

  uint32_t fixed_off[9];
  uint32_t fixed_len[9];

  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', size_t(end - p)));
    const char* le = nl ? nl : end;
    if (p < le && *p != '#') {
      // first 9 fields only; the rest are streamed in place
      int nf = 0;
      const char* f = p;
      const char* rest = nullptr;  // first sample column (field 9)
      while (nf < 9) {
        const char* t = static_cast<const char*>(
            std::memchr(f, '\t', size_t(le - f)));
        const char* fe = t ? t : le;
        fixed_off[nf] = uint32_t(f - base);
        fixed_len[nf] = uint32_t(fe - f);
        ++nf;
        if (!t) break;
        f = t + 1;
        if (nf == 9) rest = f;
      }
      if (nf < 8) {
        if (!nl) break;
        p = nl + 1;
        continue;
      }
      int64_t pv;
      const char* ps = base + fixed_off[1];
      if (!ParseInt(ps, ps + fixed_len[1], &pv)) {
        if (!nl) break;
        p = nl + 1;
        continue;
      }
      pos.push_back(pv);
      chrom_off.push_back(fixed_off[0]);
      chrom_len.push_back(fixed_len[0]);
      ref_off.push_back(fixed_off[3]);
      ref_len.push_back(fixed_len[3]);

      // ALT -> per-alt spans
      {
        const char* a = base + fixed_off[4];
        const char* ae = a + fixed_len[4];
        const char* s = a;
        while (true) {
          const char* c = static_cast<const char*>(
              std::memchr(s, ',', size_t(ae - s)));
          const char* se = c ? c : ae;
          alt_off.push_back(uint32_t(s - base));
          alt_len.push_back(uint32_t(se - s));
          if (!c) break;
          s = c + 1;
        }
      }
      const uint64_t rec_alt_begin = alt_start.back();
      alt_start.push_back(alt_len.size());
      const uint64_t rec_n_alts = alt_len.size() - rec_alt_begin;
      const uint64_t rec_index = pos.size() - 1;

      // grow plane rows for this record (zero-filled)
      g1.resize(alt_len.size() * words, 0u);
      g2.resize(alt_len.size() * words, 0u);
      t1.resize(pos.size() * words, 0u);
      t2.resize(pos.size() * words, 0u);
      uint32_t* g1r = g1.data() + rec_alt_begin * words;
      uint32_t* g2r = g2.data() + rec_alt_begin * words;
      uint32_t* t1r = t1.data() + rec_index * words;
      uint32_t* t2r = t2.data() + rec_index * words;

      // INFO: AC= / AN= / VT= (last occurrence wins)
      uint8_t h_ac = 0, h_an = 0;
      int64_t an_v = 0;
      uint32_t vt_o = 0, vt_l = 0;
      const uint64_t rec_ac_begin = ac.size();
      {
        const char* q = base + fixed_off[7];
        const char* qe = q + fixed_len[7];
        while (q < qe) {
          const char* sc = static_cast<const char*>(
              std::memchr(q, ';', size_t(qe - q)));
          const char* fe2 = sc ? sc : qe;
          if (fe2 - q >= 3 && q[2] == '=') {
            if (q[0] == 'A' && q[1] == 'C') {
              ac.resize(rec_ac_begin);
              h_ac = 1;
              const char* v = q + 3;
              while (v <= fe2) {
                const char* cm = static_cast<const char*>(
                    std::memchr(v, ',', size_t(fe2 - v)));
                const char* ve = cm ? cm : fe2;
                int64_t cv;
                if (!ParseInt(v, ve, &cv)) {
                  h_ac = 0;
                  ac.resize(rec_ac_begin);
                  break;
                }
                ac.push_back(cv);
                if (!cm) break;
                v = cm + 1;
              }
            } else if (q[0] == 'A' && q[1] == 'N') {
              h_an = ParseInt(q + 3, fe2, &an_v) ? 1 : 0;
            } else if (q[0] == 'V' && q[1] == 'T') {
              vt_o = uint32_t(q + 3 - base);
              vt_l = uint32_t(fe2 - (q + 3));
            }
          }
          if (!sc) break;
          q = sc + 1;
        }
      }
      has_ac.push_back(h_ac);
      has_an.push_back(h_an);
      an.push_back(h_an ? an_v : 0);
      vt_off.push_back(vt_o);
      vt_len.push_back(vt_l);
      ac_start.push_back(ac.size());

      // FORMAT: locate GT piece index
      int gt_idx = -1;
      if (rest != nullptr) {
        const char* fm = base + fixed_off[8];
        const char* fme = fm + fixed_len[8];
        int idx = 0;
        const char* s = fm;
        while (true) {
          const char* c = static_cast<const char*>(
              std::memchr(s, ':', size_t(fme - s)));
          const char* se = c ? c : fme;
          if (se - s == 2 && s[0] == 'G' && s[1] == 'T') {
            gt_idx = idx;
            break;
          }
          if (!c) break;
          s = c + 1;
          ++idx;
        }
      }

      ac_gt.resize(ac_gt.size() + rec_n_alts, 0);
      int64_t* rec_ac_gt = ac_gt.data() + (ac_gt.size() - rec_n_alts);
      int64_t toks = 0;

      if (gt_idx >= 0 && rest != nullptr) {
        uint64_t col = 0;  // sample index
        const char* s = rest;
        while (s <= le) {
          const char* t = static_cast<const char*>(
              std::memchr(s, '\t', size_t(le - s)));
          const char* ce = t ? t : le;  // this sample column
          // GT piece: the gt_idx-th ':'-separated slice
          const char* gs = s;
          const char* ge = nullptr;
          if (gt_idx == 0) {
            const char* c = static_cast<const char*>(
                std::memchr(gs, ':', size_t(ce - gs)));
            ge = c ? c : ce;
          } else {
            int idx = 0;
            while (idx <= gt_idx) {
              const char* c = static_cast<const char*>(
                  std::memchr(gs, ':', size_t(ce - gs)));
              if (idx == gt_idx) {
                ge = c ? c : ce;
                break;
              }
              if (!c) break;
              gs = c + 1;
              ++idx;
            }
          }
          int32_t tv_stack[16];
          int ntv = 0;
          spill.clear();
          int64_t cell_toks = 0;
          if (ge != nullptr) {
            // fast path: the overwhelming diploid shape d[|/]d
            if (ge - gs == 3 && gs[0] >= '0' && gs[0] <= '9' &&
                (gs[1] == '|' || gs[1] == '/') && gs[2] >= '0' &&
                gs[2] <= '9') {
              tv_stack[0] = gs[0] - '0';
              tv_stack[1] = gs[2] - '0';
              ntv = 2;
              cell_toks = 2;
            } else {
              for (const char* c = gs; c < ge;) {
                if (*c >= '0' && *c <= '9') {
                  int64_t v = 0;
                  while (c < ge && *c >= '0' && *c <= '9') {
                    if (v <= INT32_MAX) v = v * 10 + (*c - '0');
                    if (v > INT32_MAX) v = INT32_MAX;
                    ++c;
                  }
                  ++cell_toks;
                  if (ntv < 16) {
                    tv_stack[ntv++] = int32_t(v);
                  } else {
                    spill.push_back(int32_t(v));
                  }
                } else {
                  ++c;
                }
              }
            }
          }
          toks += cell_toks;
          // per-alt tally (all columns, like the unfused tokenizer)
          for (int k = 0; k < ntv; ++k) {
            int32_t v = tv_stack[k];
            if (v >= 1 && uint64_t(v) <= rec_n_alts) ++rec_ac_gt[v - 1];
          }
          for (int32_t v : spill) {
            if (v >= 1 && uint64_t(v) <= rec_n_alts) ++rec_ac_gt[v - 1];
          }
          // plane bits for the first n_samples columns
          if (col < n_samples) {
            const uint32_t bit = 1u << (col % 32);
            const uint64_t w = col / 32;
            if (cell_toks >= 1) t1r[w] |= bit;
            if (cell_toks >= 2) t2r[w] |= bit;
            if (cell_toks > 2) {
              tok_over.push_back(int64_t(rec_index));
              tok_over.push_back(int64_t(col));
              tok_over.push_back(cell_toks);
            }
            for (uint64_t a = 1; a <= rec_n_alts; ++a) {
              int copies = 0;
              for (int k = 0; k < ntv; ++k)
                copies += (tv_stack[k] == int32_t(a));
              for (int32_t v : spill) copies += (v == int32_t(a));
              if (copies >= 1) {
                uint32_t* row = g1r + (a - 1) * words;
                row[w] |= bit;
                if (copies >= 2) g2r[(a - 1) * words + w] |= bit;
                if (copies > 2) {
                  gt_over.push_back(int64_t(rec_alt_begin + a - 1));
                  gt_over.push_back(int64_t(col));
                  gt_over.push_back(copies);
                }
              }
            }
          }
          ++col;
          if (!t) break;
          s = t + 1;
        }
      }
      tok_total.push_back(toks);
    }
    if (!nl) break;
    p = nl + 1;
  }

  *pos_out = CopyOut(pos);
  *chrom_off_out = CopyOut(chrom_off);
  *chrom_len_out = CopyOut(chrom_len);
  *ref_off_out = CopyOut(ref_off);
  *ref_len_out = CopyOut(ref_len);
  *vt_off_out = CopyOut(vt_off);
  *vt_len_out = CopyOut(vt_len);
  *an_out = CopyOut(an);
  *has_an_out = CopyOut(has_an);
  *has_ac_out = CopyOut(has_ac);
  *tok_total_out = CopyOut(tok_total);
  *alt_off_out = CopyOut(alt_off);
  *alt_len_out = CopyOut(alt_len);
  *alt_start_out = CopyOut(alt_start);
  *ac_gt_out = CopyOut(ac_gt);
  *ac_out = CopyOut(ac);
  *ac_start_out = CopyOut(ac_start);
  *g1_out = CopyOut(g1);
  *g2_out = CopyOut(g2);
  *t1_out = CopyOut(t1);
  *t2_out = CopyOut(t2);
  *gt_over_out = CopyOut(gt_over);
  *tok_over_out = CopyOut(tok_over);
  *n_gt_over = gt_over.size() / 3;
  *n_tok_over = tok_over.size() / 3;
  *n_rec_out = pos.size();
  *n_alt_out = alt_len.size();
  *n_ac_out = ac.size();
  return 0;
}
