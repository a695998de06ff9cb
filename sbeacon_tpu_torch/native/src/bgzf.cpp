// BGZF codec: parallel block inflate over a virtual-offset range, and
// whole-stream BGZF compression.
//
// Native-component parity (SURVEY.md §2.1): this is the coherent rebuild of
// the reference's VcfChunkReader (reference: lambda/summariseSlice/source/
// vcf_chunk_reader.h — getBlockDetails header parse :143-174, per-block
// zlib inflate :233-260, window rotation) and shared/gzip streaming
// (lambda/shared/gzip/gzip.cpp deflateFile/inflateFile). The reference
// overlaps 4 S3 download threads with decompression; local files make the
// read cheap, so parallelism moves to where the time actually goes —
// per-block inflate across a thread pool (blocks are independent deflate
// streams, so decode order is free and output offsets are prefix-summed
// from each block's ISIZE footer before any inflation starts).

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

#include "thread_pool.hpp"

namespace {

struct Block {
  uint64_t coffset;  // compressed offset of block start
  uint32_t bsize;    // total block size (BSIZE+1)
  uint32_t isize;    // uncompressed payload size
  uint64_t uoffset;  // prefix-summed uncompressed offset
};

// Parse the BGZF/gzip header at buf (len bytes available); returns the
// total block size via the BC extra subfield, or 0 on error/EOF-short.
uint32_t BlockSize(const uint8_t* buf, size_t len) {
  if (len < 18) return 0;
  if (buf[0] != 0x1f || buf[1] != 0x8b || buf[2] != 8) return 0;
  if (!(buf[3] & 4)) return 0;  // FEXTRA required for BGZF
  uint16_t xlen = uint16_t(buf[10]) | (uint16_t(buf[11]) << 8);
  size_t pos = 12, end = 12 + xlen;
  if (end > len) return 0;
  while (pos + 4 <= end) {
    uint8_t si1 = buf[pos], si2 = buf[pos + 1];
    uint16_t slen = uint16_t(buf[pos + 2]) | (uint16_t(buf[pos + 3]) << 8);
    if (si1 == 66 && si2 == 67 && slen == 2) {
      if (pos + 6 > end) return 0;
      uint16_t bsize =
          uint16_t(buf[pos + 4]) | (uint16_t(buf[pos + 5]) << 8);
      return uint32_t(bsize) + 1;
    }
    pos += 4 + slen;
  }
  return 0;
}

// Inflate one raw-deflate payload into out (exactly isize bytes).
bool InflateBlock(const uint8_t* comp, size_t comp_len, uint8_t* out,
                  uint32_t isize) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(comp);
  zs.avail_in = static_cast<uInt>(comp_len);
  zs.next_out = out;
  zs.avail_out = isize;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == isize;
}

std::vector<uint8_t>* ReadFile(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  auto* data = new std::vector<uint8_t>(size_t(size));
  if (size && std::fread(data->data(), 1, size_t(size), f) != size_t(size)) {
    std::fclose(f);
    delete data;
    return nullptr;
  }
  std::fclose(f);
  return data;
}

// Shared core of sbn_inflate_range / sbn_inflate_buffer: decompress the
// virtual-offset range [vstart, vend) of a BGZF stream already resident
// in memory (compressed offsets are relative to `data`, which must begin
// at a block boundary). Same return codes as the extern entry points.
int InflateRangeCore(const uint8_t* data, size_t fsize, uint64_t vstart,
                     uint64_t vend, int n_threads, uint8_t** out,
                     uint64_t* out_len) {
  uint64_t cstart = vstart >> 16;
  uint32_t ustart = uint32_t(vstart & 0xffff);
  uint64_t cend = vend >> 16;
  uint32_t uend_within = uint32_t(vend & 0xffff);
  bool to_eof = vend == UINT64_MAX;

  // walk block headers from cstart, prefix-sum uncompressed offsets
  std::vector<Block> blocks;
  uint64_t coff = cstart, uoff = 0;
  while (coff < fsize) {
    if (!to_eof && coff > cend) break;
    uint32_t bsize = BlockSize(data + coff, fsize - coff);
    if (bsize == 0 || coff + bsize > fsize) {
      if (blocks.empty()) return 2;
      break;  // trailing garbage: stop at last good block
    }
    uint32_t isize;
    std::memcpy(&isize, data + coff + bsize - 4, 4);
    bool is_last_wanted = !to_eof && coff == cend;
    blocks.push_back({coff, bsize, isize, uoff});
    uoff += isize;
    coff += bsize;
    if (is_last_wanted) break;
    if (!to_eof && coff > cend && uend_within == 0) break;
  }
  if (blocks.empty()) {
    *out = nullptr;
    *out_len = 0;
    return 0;
  }

  uint64_t total = uoff;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(total ? total : 1));
  if (!buf) return 3;

  std::atomic<int> failed{0};
  auto payload_of = [&](const Block& b, size_t* hdr_out) {
    // deflate payload sits between the header (12 + xlen bytes) and the
    // 8-byte CRC/ISIZE footer
    uint16_t xlen = uint16_t(data[b.coffset + 10]) |
                    (uint16_t(data[b.coffset + 11]) << 8);
    *hdr_out = 12 + size_t(xlen);
    return data + b.coffset + 12 + xlen;
  };
  if (n_threads <= 1) {
    // single-core path: one reusable z_stream, no pool overhead
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) failed.store(1);
    for (const Block& b : blocks) {
      if (failed.load() || b.isize == 0) continue;
      size_t hdr;
      const uint8_t* comp = payload_of(b, &hdr);
      zs.next_in = const_cast<uint8_t*>(comp);
      zs.avail_in = static_cast<uInt>(b.bsize - hdr - 8);
      zs.next_out = buf + b.uoffset;
      zs.avail_out = b.isize;
      int rc = inflate(&zs, Z_FINISH);
      if (rc != Z_STREAM_END || zs.total_out != b.isize) failed.store(1);
      inflateReset(&zs);
    }
    inflateEnd(&zs);
  } else {
    sbn::ThreadPool pool{size_t(n_threads)};
    std::mutex mu;
    std::condition_variable cv;
    size_t remaining = blocks.size();
    for (const Block& b : blocks) {
      pool.Submit([&, b] {
        size_t hdr;
        const uint8_t* comp = payload_of(b, &hdr);
        if (b.isize > 0 &&
            !InflateBlock(comp, b.bsize - hdr - 8, buf + b.uoffset,
                          b.isize)) {
          failed.store(1);
        }
        std::unique_lock<std::mutex> lk(mu);
        if (--remaining == 0) cv.notify_one();
      });
    }
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return remaining == 0; });
  }
  if (failed.load()) {
    std::free(buf);
    return 4;
  }

  // trim to the within-block offsets of the virtual range; a start
  // offset past the first block's payload contributes nothing from
  // THAT block (the reference reader slices payload[uoff:] per block
  // — it never bleeds into the next block's bytes)
  uint64_t begin = ustart;
  if (begin > blocks.front().isize) begin = blocks.front().isize;
  uint64_t end = total;
  if (!to_eof) {
    // find the block at cend; its uoffset + uend_within bounds the range
    for (const Block& b : blocks) {
      if (b.coffset == cend) {
        end = b.uoffset + uend_within;
        break;
      }
    }
    if (end > total) end = total;
  }
  if (begin > end) begin = end;
  uint64_t n = end - begin;
  if (begin > 0) std::memmove(buf, buf + begin, n);
  *out = buf;
  *out_len = n;
  return 0;
}

}  // namespace

extern "C" {

// Decompress the virtual-offset range [vstart, vend) of a BGZF file.
// vend == UINT64_MAX means "to EOF". The caller owns *out (sbn_free).
// Returns 0 on success.
int sbn_inflate_range(const char* path, uint64_t vstart, uint64_t vend,
                      int n_threads, uint8_t** out, uint64_t* out_len) {
  std::vector<uint8_t>* file = ReadFile(path);
  if (!file) return 1;
  int rc = InflateRangeCore(file->data(), file->size(), vstart, vend,
                            n_threads, out, out_len);
  delete file;
  return rc;
}

// Decompress the virtual-offset range [vstart, vend) of a BGZF blob
// already in memory — the remote scan-blob leg, where the compressed
// span arrives by ranged GET. Offsets are relative to the blob (its
// first byte must be a block boundary); vend == UINT64_MAX means "to
// the end of the blob". The caller owns *out (sbn_free).
int sbn_inflate_buffer(const uint8_t* data, uint64_t len, uint64_t vstart,
                       uint64_t vend, int n_threads, uint8_t** out,
                       uint64_t* out_len) {
  return InflateRangeCore(data, size_t(len), vstart, vend, n_threads, out,
                          out_len);
}

// Compress data into a full BGZF stream (64KB blocks + EOF marker).
// Returns 0 on success; caller owns *out.
int sbn_compress_bgzf(const uint8_t* data, uint64_t len, int level,
                      uint8_t** out, uint64_t* out_len) {
  static const uint8_t kEof[28] = {
      0x1f, 0x8b, 0x08, 0x04, 0,    0,    0,    0,    0,    0xff,
      0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
      0,    0,    0,    0,    0,    0,    0,    0};
  const size_t kChunk = 0xff00;  // uncompressed bytes per block
  std::vector<uint8_t> result;
  result.reserve(len / 2 + 64);
  std::vector<uint8_t> comp(kChunk + 1024);
  for (uint64_t off = 0; off < len || (len == 0 && off == 0);
       off += kChunk) {
    size_t n = size_t(len - off < kChunk ? len - off : kChunk);
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return 1;
    zs.next_in = const_cast<uint8_t*>(data + off);
    zs.avail_in = static_cast<uInt>(n);
    zs.next_out = comp.data();
    zs.avail_out = static_cast<uInt>(comp.size());
    if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
      deflateEnd(&zs);
      return 1;
    }
    uint32_t csize = uint32_t(zs.total_out);
    deflateEnd(&zs);
    uint32_t crc = crc32(0, data + off, uInt(n));
    uint32_t bsize = csize + 25 + 1;  // header(18) + payload + footer(8)
    uint8_t hdr[18] = {0x1f, 0x8b, 0x08, 0x04, 0, 0,    0,    0,   0,
                       0xff, 0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0,   0};
    hdr[16] = uint8_t((bsize - 1) & 0xff);
    hdr[17] = uint8_t(((bsize - 1) >> 8) & 0xff);
    result.insert(result.end(), hdr, hdr + 18);
    result.insert(result.end(), comp.data(), comp.data() + csize);
    uint8_t footer[8];
    std::memcpy(footer, &crc, 4);
    uint32_t isize = uint32_t(n);
    std::memcpy(footer + 4, &isize, 4);
    result.insert(result.end(), footer, footer + 8);
    if (len == 0) break;
  }
  result.insert(result.end(), kEof, kEof + 28);
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(result.size()));
  if (!buf) return 3;
  std::memcpy(buf, result.data(), result.size());
  *out = buf;
  *out_len = result.size();
  return 0;
}

void sbn_free(uint8_t* p) { std::free(p); }

}  // extern "C"
