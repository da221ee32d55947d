// Native batch image decode: JPEG (libjpeg) + PNG (libpng) -> uint8 tensors.
//
// A copy of the JAX package's decoder (petastorm_tpu/native/imgcodec.cpp),
// the native counterpart of cv2.imdecode (petastorm/codecs.py:58-132):
// decodes a whole Parquet row group's image column in ONE C call with
// an internal thread fan-out, writing each image into its own caller-
// provided buffer (independently-allocated per-row arrays, so a retained
// row never pins its row group's other images), sparing the Python side
// per-image call overhead and the cv2 path's extra BGR->RGB pass.
//
// Output is always RGB-ordered (or grayscale); channel conversion happens
// inside the codec libraries (libjpeg out_color_space / libpng format
// transforms). Unsupported inputs (16-bit PNG, CMYK JPEG, progressive
// corruption, dimension mismatch) fail per-image with a status code so the
// caller can fall back to its Python path for just those cells.
//
// Build (native/imgcodec.py does it at first use, into build/torch_native/):
// g++ -O2 -shared -fPIC -std=c++17 imgcodec.cpp -o libptimg.so -ljpeg -lpng
// [-DPT_HAVE_DEFLATE -ldeflate]

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

// libdeflate is optional: the build helper first compiles with
// -DPT_HAVE_DEFLATE -ldeflate and retries without on failure, so hosts
// lacking libdeflate keep the full JPEG + libpng PNG paths.
#ifdef PT_HAVE_DEFLATE
#include <libdeflate.h>
#endif

namespace {

// ------------------------------------------------------------------ status
enum PtImgStatus {
  PTIMG_OK = 0,
  PTIMG_ERR_FORMAT = -1,       // not a recognizable JPEG/PNG stream
  PTIMG_ERR_UNSUPPORTED = -2,  // valid but outside our contract (16-bit, CMYK)
  PTIMG_ERR_DIMS = -3,         // decoded dims/channels != caller's buffer
  PTIMG_ERR_CORRUPT = -4,      // codec library reported an error mid-decode
  PTIMG_ERR_ARGS = -5,
};

constexpr unsigned char kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

bool is_png(const unsigned char* blob, uint64_t size) {
  return size >= 8 && std::memcmp(blob, kPngSig, 8) == 0;
}

bool is_jpeg(const unsigned char* blob, uint64_t size) {
  return size >= 3 && blob[0] == 0xFF && blob[1] == 0xD8 && blob[2] == 0xFF;
}

// ------------------------------------------------------------------- JPEG
// libjpeg's default error handler calls exit(); trampoline through setjmp.
struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

void jpeg_silent(j_common_ptr, int) {}

// Lightweight SOF-marker scan — callers probe then decode, and a full
// jpeg_read_header here would parse every header twice per cell.
int jpeg_probe(const unsigned char* blob, uint64_t size, int* h, int* w, int* c) {
  uint64_t off = 2;  // past FFD8
  while (off + 4 <= size) {
    if (blob[off] != 0xFF) return PTIMG_ERR_CORRUPT;
    unsigned char marker = blob[off + 1];
    while (marker == 0xFF && off + 2 < size) {  // fill bytes
      ++off;
      marker = blob[off + 1];
    }
    // The fill skip moved off without the outer bound; re-establish it
    // before any blob[off+2..3] read (truncated blobs ending in 0xFF
    // padding would otherwise read past the buffer).
    if (marker == 0xFF || off + 4 > size) return PTIMG_ERR_CORRUPT;
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) {
      off += 2;  // standalone markers carry no length
      continue;
    }
    if (marker == 0xD9 || marker == 0xDA) break;  // EOI / start of scan
    uint32_t seg_len = (uint32_t(blob[off + 2]) << 8) | blob[off + 3];
    if (seg_len < 2 || off + 2 + seg_len > size) return PTIMG_ERR_CORRUPT;
    bool is_sof = (marker >= 0xC0 && marker <= 0xCF) && marker != 0xC4 &&
                  marker != 0xC8 && marker != 0xCC;
    if (is_sof) {
      if (seg_len < 8) return PTIMG_ERR_CORRUPT;
      int precision = blob[off + 4];
      if (precision != 8) return PTIMG_ERR_UNSUPPORTED;
      *h = (int(blob[off + 5]) << 8) | blob[off + 6];
      *w = (int(blob[off + 7]) << 8) | blob[off + 8];
      int comps = blob[off + 9];
      if (comps == 1) { *c = 1; return PTIMG_OK; }
      if (comps == 3) { *c = 3; return PTIMG_OK; }
      return PTIMG_ERR_UNSUPPORTED;  // CMYK / YCCK
    }
    off += 2 + seg_len;
  }
  return PTIMG_ERR_FORMAT;
}

// strict_channels: require the SOURCE's native decoded channel count to
// equal c (the caller's buffer). This is cv2.IMREAD_UNCHANGED parity — the
// Python fallback path never channel-converts, so the native path must
// reject (rather than convert) mismatched sources and let the caller fall
// back per-cell.
int jpeg_decode(const unsigned char* blob, uint64_t size,
                unsigned char* out, int h, int w, int c,
                bool strict_channels) {
  if (c != 1 && c != 3) return PTIMG_ERR_UNSUPPORTED;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.emit_message = jpeg_silent;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return PTIMG_ERR_CORRUPT;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(blob), size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return PTIMG_ERR_FORMAT;
  }
  if (cinfo.num_components != 1 && cinfo.num_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return PTIMG_ERR_UNSUPPORTED;
  }
  if (strict_channels && (cinfo.num_components == 1 ? 1 : 3) != c) {
    jpeg_destroy_decompress(&cinfo);
    return PTIMG_ERR_DIMS;
  }
  // libjpeg converts gray<->RGB on decode when asked (non-strict mode).
  cinfo.out_color_space = (c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != c) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return PTIMG_ERR_DIMS;
  }
  const size_t stride = static_cast<size_t>(w) * c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return PTIMG_OK;
}

// -------------------------------------------------------------------- PNG
// Parse IHDR directly for the probe (signature + fixed layout: width/height
// big-endian at byte 16/20, bit depth at 24, color type at 25).
uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Native decoded channel count for a PNG color type (palette expands to
// RGB), or -1 when unrecognized. cv2 parity note: IMREAD_UNCHANGED also
// expands palette PNGs to 3 channels.
int png_native_channels(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 3: return 3;  // palette -> expanded to rgb
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
    default: return -1;
  }
}

int png_probe(const unsigned char* blob, uint64_t size, int* h, int* w, int* c) {
  if (size < 26) return PTIMG_ERR_FORMAT;
  if (std::memcmp(blob + 12, "IHDR", 4) != 0) return PTIMG_ERR_FORMAT;
  *w = static_cast<int>(be32(blob + 16));
  *h = static_cast<int>(be32(blob + 20));
  int bit_depth = blob[24];
  int color_type = blob[25];
  if (bit_depth > 8) return PTIMG_ERR_UNSUPPORTED;  // 16-bit: caller fallback
  int channels = png_native_channels(color_type);
  if (channels < 0) return PTIMG_ERR_FORMAT;
  *c = channels;
  return PTIMG_OK;
}

// --------------------------------------------------- PNG fast path
// The common DL-store case — 8-bit gray/RGB, non-interlaced, no
// transparency — decoded with libdeflate (2-3x faster inflate than zlib)
// plus a hand-rolled scanline defilter, writing straight into the caller's
// buffer. Anything else (palette, alpha/tRNS, 16-bit, interlaced, channel
// conversion) falls through to the libpng simplified API below. Chunk CRCs
// are not verified (the zlib adler32 still is, via libdeflate).
constexpr int PTIMG_FALLBACK = -100;  // internal: use the libpng path

#ifdef PT_HAVE_DEFLATE

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

int png_decode_fast(const unsigned char* blob, uint64_t size,
                    unsigned char* out, int h, int w, int c) {
  if (size < 45) return PTIMG_FALLBACK;  // sig + IHDR + IDAT hdr + IEND
  // IHDR is validated/parsed at fixed offsets (png_probe checked the tag).
  if (std::memcmp(blob + 12, "IHDR", 4) != 0) return PTIMG_ERR_FORMAT;
  int width = static_cast<int>(be32(blob + 16));
  int height = static_cast<int>(be32(blob + 20));
  int bit_depth = blob[24];
  int color_type = blob[25];
  int compression = blob[26];
  int filter_method = blob[27];
  int interlace = blob[28];
  if (bit_depth != 8 || compression != 0 || filter_method != 0 ||
      interlace != 0) {
    return PTIMG_FALLBACK;
  }
  if (color_type != 0 && color_type != 2) return PTIMG_FALLBACK;
  int native_c = color_type == 2 ? 3 : 1;
  if (native_c != c) {
    // Channel mismatch is NOT a verdict yet — a tRNS chunk (only visible
    // in the scan below) would make cv2 expand this source to 4 channels,
    // so hand the blob to the libpng path, whose format flags decide
    // strict-parity accept/reject correctly in every case.
    return PTIMG_FALLBACK;
  }
  if (width != w || height != h) return PTIMG_ERR_DIMS;

  // Chunk walk: collect IDAT spans, bail on tRNS (cv2 expands it to alpha).
  struct Span { const unsigned char* p; size_t len; };
  std::vector<Span> idat;
  size_t idat_total = 0;
  uint64_t off = 8;
  while (off + 12 <= size) {
    uint32_t len = be32(blob + off);
    const unsigned char* type = blob + off + 4;
    if (off + 12 + len > size) return PTIMG_ERR_CORRUPT;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.push_back({blob + off + 8, len});
      idat_total += len;
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      return PTIMG_FALLBACK;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (idat.empty()) return PTIMG_ERR_CORRUPT;

  const unsigned char* zdata;
  std::vector<unsigned char> zconcat;
  if (idat.size() == 1) {
    zdata = idat[0].p;
  } else {
    zconcat.reserve(idat_total);
    for (const Span& s : idat) zconcat.insert(zconcat.end(), s.p, s.p + s.len);
    zdata = zconcat.data();
  }

  const size_t stride = static_cast<size_t>(w) * c;
  const size_t raw_size = (stride + 1) * h;  // +1 filter byte per scanline
  thread_local std::vector<unsigned char> raw_buf;
  if (raw_buf.size() < raw_size) raw_buf.resize(raw_size);
  // RAII so the decompressor is released at thread exit — the batch entry
  // spawns short-lived threads, and a bare thread_local pointer would leak
  // one decompressor per thread per batch call.
  struct DecompressorHolder {
    libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    ~DecompressorHolder() {
      if (d != nullptr) libdeflate_free_decompressor(d);
    }
  };
  thread_local DecompressorHolder dec;
  if (dec.d == nullptr) return PTIMG_FALLBACK;
  size_t actual = 0;
  if (libdeflate_zlib_decompress(dec.d, zdata, idat_total, raw_buf.data(),
                                 raw_size, &actual) != LIBDEFLATE_SUCCESS ||
      actual != raw_size) {
    return PTIMG_ERR_CORRUPT;
  }

  // Defilter each scanline directly into the caller's buffer: the filters
  // reference DECODED bytes (left a, up b, up-left c), all already in out.
  const int bpp = c;
  for (int y = 0; y < h; ++y) {
    const unsigned char* src = raw_buf.data() + y * (stride + 1);
    unsigned char filter = src[0];
    ++src;
    unsigned char* dst = out + y * stride;
    const unsigned char* up = y > 0 ? dst - stride : nullptr;
    switch (filter) {
      case 0:  // None
        std::memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        std::memcpy(dst, src, bpp);
        for (size_t i = bpp; i < stride; ++i) dst[i] = src[i] + dst[i - bpp];
        break;
      case 2:  // Up
        if (up == nullptr) {
          std::memcpy(dst, src, stride);
        } else {
          for (size_t i = 0; i < stride; ++i) dst[i] = src[i] + up[i];
        }
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= static_cast<size_t>(bpp) ? dst[i - bpp] : 0;
          int b = up != nullptr ? up[i] : 0;
          dst[i] = src[i] + static_cast<unsigned char>((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= static_cast<size_t>(bpp) ? dst[i - bpp] : 0;
          int b = up != nullptr ? up[i] : 0;
          int pc = (up != nullptr && i >= static_cast<size_t>(bpp))
                       ? up[i - bpp] : 0;
          dst[i] = src[i] + static_cast<unsigned char>(paeth(a, b, pc));
        }
        break;
      default:
        return PTIMG_ERR_CORRUPT;
    }
  }
  return PTIMG_OK;
}

#endif  // PT_HAVE_DEFLATE

int png_decode(const unsigned char* blob, uint64_t size,
               unsigned char* out, int h, int w, int c,
               bool strict_channels) {
#ifdef PT_HAVE_DEFLATE
  int rc = png_decode_fast(blob, size, out, h, w, c);
  if (rc != PTIMG_FALLBACK) return rc;
#endif
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, blob, size)) {
    return PTIMG_ERR_FORMAT;
  }
  if ((image.format & PNG_FORMAT_FLAG_LINEAR) != 0) {
    png_image_free(&image);
    return PTIMG_ERR_UNSUPPORTED;  // 16-bit source: keep cv2 semantics
  }
  if (strict_channels) {
    // cv2.IMREAD_UNCHANGED parity (measured): ANY transparency — explicit
    // alpha channel, gray+alpha, or a tRNS chunk (libpng sets
    // PNG_FORMAT_FLAG_ALPHA for all of them) — decodes to 4 channels;
    // otherwise color (incl. palette) is 3 and grayscale is 1.
    int cv2_channels = (image.format & PNG_FORMAT_FLAG_ALPHA)
                           ? 4
                           : ((image.format & PNG_FORMAT_FLAG_COLOR) ? 3 : 1);
    if (cv2_channels != c) {
      png_image_free(&image);
      return PTIMG_ERR_DIMS;
    }
  }
  switch (c) {  // libpng applies palette/gray/alpha transforms for us
    case 1: image.format = PNG_FORMAT_GRAY; break;
    case 2: image.format = PNG_FORMAT_GA; break;
    case 3: image.format = PNG_FORMAT_RGB; break;
    case 4: image.format = PNG_FORMAT_RGBA; break;
    default: png_image_free(&image); return PTIMG_ERR_ARGS;
  }
  if (static_cast<int>(image.height) != h || static_cast<int>(image.width) != w) {
    png_image_free(&image);
    return PTIMG_ERR_DIMS;
  }
  if (!png_image_finish_read(&image, nullptr, out,
                             static_cast<png_int_32>(w) * c, nullptr)) {
    png_image_free(&image);
    return PTIMG_ERR_CORRUPT;
  }
  return PTIMG_OK;
}

int decode_one(const unsigned char* blob, uint64_t size,
               unsigned char* out, int h, int w, int c, bool strict) {
  if (blob == nullptr || out == nullptr || h <= 0 || w <= 0) return PTIMG_ERR_ARGS;
  if (is_png(blob, size)) return png_decode(blob, size, out, h, w, c, strict);
  if (is_jpeg(blob, size)) return jpeg_decode(blob, size, out, h, w, c, strict);
  return PTIMG_ERR_FORMAT;
}

}  // namespace

extern "C" {

// Fill (h, w, c) from the encoded header without a full decode. c is the
// image's NATIVE decoded channel count (palette PNG reports 3).
int pt_img_probe(const unsigned char* blob, uint64_t size,
                 int* h, int* w, int* c) {
  if (blob == nullptr || size < 8) return PTIMG_ERR_ARGS;
  if (is_png(blob, size)) return png_probe(blob, size, h, w, c);
  if (is_jpeg(blob, size)) return jpeg_probe(blob, size, h, w, c);
  return PTIMG_ERR_FORMAT;
}

// Decode one image into out[h*w*c] (uint8, RGB channel order). With
// strict=0 the source is channel-converted to c where the codec allows
// (jpeg gray<->rgb; png palette/gray/alpha -> any of gray/ga/rgb/rgba);
// with strict=1 a source whose native channel count differs from c fails
// with PTIMG_ERR_DIMS (cv2.IMREAD_UNCHANGED parity for fallback callers).
int pt_img_decode(const unsigned char* blob, uint64_t size,
                  unsigned char* out, int h, int w, int c, int strict) {
  return decode_one(blob, size, out, h, w, c, strict != 0);
}

// Decode n images, each into its own caller-provided buffer (outs[i],
// h*w*c bytes), with an internal thread fan-out. statuses[i] gets the
// per-image PtImgStatus; returns the failure count. Caller threads
// (Python) hold no GIL during this call, so n_threads=1 is already a win
// over per-image Python calls; >1 parallelizes the decode. Per-image
// buffers keep row lifetimes independent — retaining one decoded row must
// not pin a whole row group's batch.
int pt_img_decode_batch_ptrs(const unsigned char** blobs,
                             const uint64_t* sizes, int n,
                             unsigned char** outs, int h, int w, int c,
                             int n_threads, int strict, int* statuses) {
  if (n <= 0) return 0;
  if (blobs == nullptr || sizes == nullptr || outs == nullptr ||
      statuses == nullptr) {
    return n;
  }
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto work = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int rc = decode_one(blobs[i], sizes[i], outs[i], h, w, c, strict != 0);
      statuses[i] = rc;
      if (rc != PTIMG_OK) failures.fetch_add(1);
    }
  };
  int workers = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  if (workers == 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(workers);
    for (int t = 0; t < workers; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

}  // extern "C"
