// fastimage: batched JPEG decode + bilinear resize for the data pipeline,
// a JPEG decode of encoded bytes for serving, and the PNG row unfilter.
//
// The port's copy of the JAX package's native/fastimage.cpp: the batch
// decode (libjpeg's DCT-domain scaling to the smallest 1/2^k scale that
// still covers the target, then a plain half-pixel bilinear resize, over a
// std::thread pool) is the same code, so the two packages decode a JPEG
// file to the same bytes. Two C entry points are added:
//
//   fastimage_jpeg_mem_info / fastimage_jpeg_mem_decode: a JPEG held in
//     memory (an HTTP request body) decoded at full scale to RGB, as Pillow
//     decodes it; the resize to the model's input is done by the caller
//     (data/image_io.resize_u8, Pillow's bilinear filter).
//   fastimage_png_unfilter: the five PNG scanline filters undone in place
//     (Paeth and Average depend on the pixel to the left, which a numpy
//     expression cannot vectorise along a row).
//   fastimage_resample_bilinear: Pillow's Image.resize(..., BILINEAR) of
//     8-bit samples byte for byte (its ImagingResample: separable, the
//     horizontal pass then the vertical one, a triangle filter whose
//     support grows with the reduction ratio, 22-bit fixed-point
//     coefficients, each pass rounded and clipped to uint8).
//
// The JPEG code needs libjpeg's headers; where they are missing the
// library still builds (__has_include), fastimage_has_jpeg() returns 0
// and the JPEG entry points fail every image, so Python falls back.
//
// C ABI (used from Python via ctypes):
//   fastimage_decode_batch(paths, n, out, H, W, ok, threads) -> number of
//   images successfully decoded; failures leave zeros and are flagged in
//   `ok` so Python can fall back per file (e.g. for PNGs).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#if !defined(FASTIMAGE_NO_JPEG) && __has_include(<jpeglib.h>)
#include <jpeglib.h>
#define FASTIMAGE_JPEG 1
#else
#define FASTIMAGE_JPEG 0
#endif

namespace {

#if FASTIMAGE_JPEG
struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}
#endif  // FASTIMAGE_JPEG

// Bilinear resize uint8 HWC -> uint8 HWC (align_corners=false, PIL-like
// half-pixel centers; not Pillow's filter: the JAX package's loader, whose
// bytes this copy keeps). Unused in a build without libjpeg.
[[maybe_unused]] void resize_bilinear(const uint8_t* src, int sh, int sw,
                                      uint8_t* dst, int dh, int dw,
                                      int ch) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      for (int c = 0; c < ch; ++c) {
        const float top = src[(y0 * sw + x0) * ch + c] * (1 - wx)
                        + src[(y0 * sw + x1) * ch + c] * wx;
        const float bot = src[(y1 * sw + x0) * ch + c] * (1 - wx)
                        + src[(y1 * sw + x1) * ch + c] * wx;
        dst[(y * dw + x) * ch + c] =
            static_cast<uint8_t>(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

bool decode_one(const char* path, uint8_t* out, int dh, int dw) {
#if !FASTIMAGE_JPEG
  (void)path; (void)out; (void)dh; (void)dw;
  return false;
#else
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain downscale: decode at the smallest 1/2^k scale that still
  // covers the target (keeps >= target resolution before the final resize).
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 2; denom /= 2) {
    if (static_cast<int>(cinfo.image_height) / denom >= dh &&
        static_cast<int>(cinfo.image_width) / denom >= dw) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  const int sh = cinfo.output_height;
  const int sw = cinfo.output_width;
  const int ch = cinfo.output_components;  // 3 for JCS_RGB
  std::vector<uint8_t> buf(static_cast<size_t>(sh) * sw * ch);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + static_cast<size_t>(cinfo.output_scanline)
                   * sw * ch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  if (ch != 3) {  // grayscale etc.: expand to RGB
    std::vector<uint8_t> rgb(static_cast<size_t>(sh) * sw * 3);
    for (size_t i = 0; i < static_cast<size_t>(sh) * sw; ++i)
      for (int c = 0; c < 3; ++c) rgb[i * 3 + c] = buf[i * ch];
    resize_bilinear(rgb.data(), sh, sw, out, dh, dw, 3);
  } else {
    resize_bilinear(buf.data(), sh, sw, out, dh, dw, 3);
  }
  return true;
#endif  // FASTIMAGE_JPEG
}

#if FASTIMAGE_JPEG
// Full-scale decode of an in-memory JPEG to RGB into `out` (h*w*3 bytes,
// or nullptr to read the size only). Returns false on a libjpeg error, on
// a colour space other than YCbCr or grayscale (CMYK: Python falls back),
// or when `out`'s size disagrees with the header.
bool decode_mem(const uint8_t* data, size_t n, uint8_t* out, int* h,
                int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  std::vector<uint8_t> gray;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
  const bool is_gray = cinfo.jpeg_color_space == JCS_GRAYSCALE;
  if (!is_gray && cinfo.jpeg_color_space != JCS_YCbCr &&
      cinfo.jpeg_color_space != JCS_RGB) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (out == nullptr) {
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  if (static_cast<int>(cinfo.image_height) != *h ||
      static_cast<int>(cinfo.image_width) != *w) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // a gray image decodes as one channel and is replicated, as Pillow's
  // convert("RGB") replicates its "L" mode
  cinfo.out_color_space = is_gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width;
  const int ch = cinfo.output_components;
  if (ch == 1) gray.resize(static_cast<size_t>(sw));
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    uint8_t* row = ch == 1 ? gray.data() : dst;
    jpeg_read_scanlines(&cinfo, &row, 1);
    if (ch == 1)
      for (int x = 0; x < sw; ++x)
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = gray[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#endif  // FASTIMAGE_JPEG

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Pillow's Resample.c for 8-bit samples: precompute_coeffs with the
// bilinear filter, then normalize_coeffs_8bpc.
constexpr int kPrecisionBits = 32 - 8 - 2;

struct Coeffs {
  size_t ksize;
  std::vector<size_t> first, taps;  // per output index
  std::vector<int32_t> k;           // [out, ksize] fixed point
};

Coeffs bilinear_coeffs(size_t in_size, size_t out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  Coeffs c;
  c.ksize = static_cast<size_t>(std::ceil(support)) * 2 + 1;
  c.first.resize(out_size);
  c.taps.resize(out_size);
  c.k.assign(out_size * c.ksize, 0);
  std::vector<double> w(c.ksize);
  const double ss = 1.0 / filterscale;
  for (size_t xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    // C's casts truncate toward zero, as Pillow's (int) does
    const double lo = std::trunc(center - support + 0.5);
    const double hi = std::trunc(center + support + 0.5);
    const size_t xmin = lo < 0.0 ? 0 : static_cast<size_t>(lo);
    const size_t xmax =
        std::min(static_cast<size_t>(hi), in_size) - xmin;
    double ww = 0.0;
    for (size_t x = 0; x < xmax; ++x) {
      const double t = std::fabs(
          (static_cast<double>(x + xmin) - center + 0.5) * ss);
      w[x] = t < 1.0 ? 1.0 - t : 0.0;
      ww += w[x];
    }
    for (size_t x = 0; x < xmax; ++x)
      if (ww != 0.0) w[x] /= ww;
    int32_t* k = &c.k[xx * c.ksize];
    for (size_t x = 0; x < xmax; ++x) {
      const double f = w[x] * (1 << kPrecisionBits);
      k[x] = static_cast<int32_t>(w[x] < 0 ? -0.5 + f : 0.5 + f);
    }
    c.first[xx] = xmin;
    c.taps[xx] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t v) {
  const int32_t s = v >> kPrecisionBits;
  return static_cast<uint8_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
}

// The horizontal pass: `rows` rows of `in_w` pixels of `ch` samples
// resampled to `out_w` pixels. The sums fit int32 as in Pillow: the
// weights are >= 0 and add up to about 2**22, so 255 of them stay below
// 2**31.
void horizontal_pass(const uint8_t* src, uint8_t* dst, size_t rows,
                     size_t in_w, size_t out_w, size_t ch) {
  const Coeffs c = bilinear_coeffs(in_w, out_w);
  for (size_t y = 0; y < rows; ++y) {
    const uint8_t* in = src + y * in_w * ch;
    uint8_t* out = dst + y * out_w * ch;
    for (size_t o = 0; o < out_w; ++o) {
      const int32_t* k = &c.k[o * c.ksize];
      const uint8_t* base = in + c.first[o] * ch;
      for (size_t q = 0; q < ch; ++q) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (size_t t = 0; t < c.taps[o]; ++t) ss += base[t * ch + q] * k[t];
        out[o * ch + q] = clip8(ss);
      }
    }
  }
}

// The vertical pass: rows of `row_len` samples, `in_h` of them resampled
// to `out_h`; a whole row is accumulated at once (the sums are integers,
// so the order of the taps does not change them).
void vertical_pass(const uint8_t* src, uint8_t* dst, size_t in_h,
                   size_t out_h, size_t row_len) {
  const Coeffs c = bilinear_coeffs(in_h, out_h);
  std::vector<int32_t> acc(row_len);
  for (size_t o = 0; o < out_h; ++o) {
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (size_t t = 0; t < c.taps[o]; ++t) {
      const uint8_t* r = src + (c.first[o] + t) * row_len;
      const int32_t kt = c.k[o * c.ksize + t];
      for (size_t x = 0; x < row_len; ++x) acc[x] += r[x] * kt;
    }
    uint8_t* out = dst + o * row_len;
    for (size_t x = 0; x < row_len; ++x) out[x] = clip8(acc[x]);
  }
}

}  // namespace

extern "C" {

int fastimage_has_jpeg() { return FASTIMAGE_JPEG; }

// paths: array of n C strings; out: n*H*W*3 uint8 buffer; ok: n bytes
// (1 = decoded, 0 = failed -> caller falls back). Returns #decoded.
int fastimage_decode_batch(const char** paths, int n, uint8_t* out,
                           int height, int width, uint8_t* ok,
                           int threads) {
  std::atomic<int> next(0), good(0);
  const size_t stride = static_cast<size_t>(height) * width * 3;
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      const bool success = decode_one(paths[i], out + stride * i, height,
                                      width);
      ok[i] = success ? 1 : 0;
      if (success) good.fetch_add(1);
      else std::memset(out + stride * i, 0, stride);
    }
  };
  const int nt = std::max(1, std::min(threads, n));
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return good.load();
}

// The full-scale size of an in-memory JPEG: 1 and *h, *w set, or 0 (not a
// JPEG libjpeg reads, a colour space other than YCbCr/RGB/gray, or no
// libjpeg in this build).
int fastimage_jpeg_mem_info(const uint8_t* data, size_t n, int* h, int* w) {
#if FASTIMAGE_JPEG
  return decode_mem(data, n, nullptr, h, w) ? 1 : 0;
#else
  (void)data; (void)n; (void)h; (void)w;
  return 0;
#endif
}

// Decode an in-memory JPEG at full scale into out (h*w*3 RGB bytes, the
// size fastimage_jpeg_mem_info gave). Returns 1, or 0 on failure.
int fastimage_jpeg_mem_decode(const uint8_t* data, size_t n, uint8_t* out,
                              int h, int w) {
#if FASTIMAGE_JPEG
  return decode_mem(data, n, out, &h, &w) ? 1 : 0;
#else
  (void)data; (void)n; (void)out; (void)h; (void)w;
  return 0;
#endif
}

// Undo the PNG filters of `height` scanlines in place. `data` holds the
// inflated image: each row a filter-type byte and `row_bytes` bytes; the
// unfiltered rows are written to out (height*row_bytes). bpp: bytes per
// complete pixel (the filters' left neighbour). Returns 1, or 0 on a
// filter type outside 0..4.
int fastimage_png_unfilter(const uint8_t* data, size_t height,
                           size_t row_bytes, size_t bpp, uint8_t* out) {
  const size_t rb = row_bytes;
  for (size_t y = 0; y < height; ++y) {
    const uint8_t* src = data + y * (rb + 1);
    const int type = src[0];
    ++src;
    uint8_t* row = out + y * rb;
    const uint8_t* up = y > 0 ? out + (y - 1) * rb : nullptr;
    switch (type) {
      case 0:
        std::memcpy(row, src, rb);
        break;
      case 1:
        for (size_t x = 0; x < rb; ++x)
          row[x] = src[x] + (x >= bpp ? row[x - bpp] : 0);
        break;
      case 2:
        for (size_t x = 0; x < rb; ++x) row[x] = src[x] + (up ? up[x] : 0);
        break;
      case 3:
        for (size_t x = 0; x < rb; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          row[x] = static_cast<uint8_t>(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < rb; ++x) {
          const bool left = x >= bpp;
          const int a = left ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = left && up ? up[x - bpp] : 0;
          row[x] = static_cast<uint8_t>(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return 0;
    }
  }
  return 1;
}

// Resize src (in_h*in_w*ch uint8, HWC) to out (out_h*out_w*ch) as
// Pillow's Image.resize((out_w, out_h), BILINEAR) does for each band: the
// horizontal pass into a temporary of in_h*out_w*ch, then the vertical
// pass; an axis whose size does not change is not resampled. Returns 1,
// or 0 on a size of 0.
int fastimage_resample_bilinear(const uint8_t* src, size_t in_h,
                                size_t in_w, size_t ch, uint8_t* out,
                                size_t out_h, size_t out_w) {
  if (!in_h || !in_w || !ch || !out_h || !out_w) return 0;
  std::vector<uint8_t> mid;
  const uint8_t* rows = src;
  if (out_w != in_w) {
    uint8_t* dst = out;
    if (out_h != in_h) {
      mid.resize(in_h * out_w * ch);
      dst = mid.data();
    }
    horizontal_pass(src, dst, in_h, in_w, out_w, ch);
    rows = dst;
  }
  if (out_h != in_h) {
    vertical_pass(rows, out, in_h, out_h, out_w * ch);
  } else if (out_w == in_w) {
    std::memcpy(out, src, in_h * in_w * ch);
  }
  return 1;
}

}  // extern "C"
