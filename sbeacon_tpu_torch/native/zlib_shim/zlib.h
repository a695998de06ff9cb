/* The few zlib declarations the native sources use, for a host that has
 * the zlib runtime (libz.so.1, which Python's own zlib module loads) but
 * not its development header. The build passes this directory with
 * -idirafter, so an installed <zlib.h> always takes precedence. The
 * layout of z_stream and the constants are zlib 1.2.x/1.3.x's, stable
 * across those releases. */
#ifndef SBN_ZLIB_SHIM_H
#define SBN_ZLIB_SHIM_H

#ifdef __cplusplus
extern "C" {
#endif

#define ZLIB_VERSION "1.2.13"

typedef unsigned char Bytef;
typedef unsigned int uInt;
typedef unsigned long uLong;
typedef void* voidpf;
typedef voidpf (*alloc_func)(voidpf opaque, uInt items, uInt size);
typedef void (*free_func)(voidpf opaque, voidpf address);
struct internal_state;

typedef struct z_stream_s {
  const Bytef* next_in;
  uInt avail_in;
  uLong total_in;
  Bytef* next_out;
  uInt avail_out;
  uLong total_out;
  const char* msg;
  struct internal_state* state;
  alloc_func zalloc;
  free_func zfree;
  voidpf opaque;
  int data_type;
  uLong adler;
  uLong reserved;
} z_stream;

typedef z_stream* z_streamp;

#define Z_NO_FLUSH 0
#define Z_FINISH 4
#define Z_OK 0
#define Z_STREAM_END 1
#define Z_DEFAULT_STRATEGY 0
#define Z_DEFLATED 8

int inflate(z_streamp strm, int flush);
int inflateEnd(z_streamp strm);
int inflateReset(z_streamp strm);
int deflate(z_streamp strm, int flush);
int deflateEnd(z_streamp strm);
uLong deflateBound(z_streamp strm, uLong sourceLen);
uLong crc32(uLong crc, const Bytef* buf, uInt len);
int deflateInit2_(z_streamp strm, int level, int method, int windowBits,
                  int memLevel, int strategy, const char* version,
                  int stream_size);
int inflateInit2_(z_streamp strm, int windowBits, const char* version,
                  int stream_size);

#define deflateInit2(strm, level, method, windowBits, memLevel, strategy) \
  deflateInit2_((strm), (level), (method), (windowBits), (memLevel),      \
                (strategy), ZLIB_VERSION, (int)sizeof(z_stream))
#define inflateInit2(strm, windowBits) \
  inflateInit2_((strm), (windowBits), ZLIB_VERSION, (int)sizeof(z_stream))

#ifdef __cplusplus
}
#endif

#endif /* SBN_ZLIB_SHIM_H */
