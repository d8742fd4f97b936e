// fastload: threaded PNG/JPEG frame decoding into time-major float batches.
//
// The host-side IO layer of the PyTorch port, a copy of
// dvg_tpu/runtime/native/fastload.cpp (the same C ABI and the same
// arithmetic, so both decode bit for bit alike). The reference feeds its
// GPU from torch DataLoader worker processes doing scipy.misc PNG reads
// (reference data/bair.py:47-55, kth.py:46-55); this library replaces that
// path with a C++ thread pool that decodes, resizes (bilinear), normalizes
// to [0,1] float32, and writes straight into the caller-provided (T, B, H, W, C)
// buffer — one allocation, no Python in the frame loop.
//
// C ABI (ctypes-friendly):
//   dvg_decode_batch(paths, n, out_h, out_w, channels, out, n_threads)
//     paths: array of n C strings; frame k writes to out + k*H*W*C.
//     channels: 1 (grayscale) or 3 (RGB). Returns 0 on success, else the
//     (1-based) index of the first failed path negated.
//
// Build: dvg_tpu_torch/runtime/fastload.py compiles it with g++ at first use
// into dvg_tpu_torch/build/ (-O3 -fPIC -std=c++17 -shared, -lpng -ljpeg -lz
// -lpthread).

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> data;  // H*W*C, C in {1,3}
  int h = 0, w = 0, c = 0;
};

bool has_suffix(const char* path, const char* suf) {
  size_t lp = std::strlen(path), ls = std::strlen(suf);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; i++) {
    char a = path[lp - ls + i], b = suf[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

bool decode_png(const char* path, int want_c, Image* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(f);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {  // allocation failure / libpng mismatch: fall back, don't crash
    std::fclose(f);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(f);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (want_c == 3 &&
      (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA))
    png_set_gray_to_rgb(png);
  if (want_c == 1 &&
      (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
       color == PNG_COLOR_TYPE_PALETTE))
    // ITU-R 601 luma (PIL convert("L") weights): 0.299 R + 0.587 G + 0.114 B
    png_set_rgb_to_gray(png, 1, 0.299, 0.587);
  png_read_update_info(png, info);

  out->h = (int)png_get_image_height(png, info);
  out->w = (int)png_get_image_width(png, info);
  out->c = (int)png_get_channels(png, info);
  out->data.resize((size_t)out->h * out->w * out->c);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; y++)
    rows[y] = out->data.data() + (size_t)y * out->w * out->c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return out->c == want_c;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const char* path, int want_c, Image* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (want_c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = (int)cinfo.output_height;
  out->w = (int)cinfo.output_width;
  out->c = (int)cinfo.output_components;
  out->data.resize((size_t)out->h * out->w * out->c);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out->data.data() + (size_t)cinfo.output_scanline * out->w * out->c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return out->c == want_c;
}

// ---------------------------------------------------------------------------
// bilinear resize + [0,1] normalize into the output slot
// ---------------------------------------------------------------------------

// Separable triangle (bilinear) resampling matching PIL Image.BILINEAR:
// filter support scales with the downsampling ratio (area-averaging when
// shrinking), pixel-center alignment, per-row normalized weights.
struct FilterTaps {
  std::vector<int> xmin, xsize;
  std::vector<float> weights;  // per output pixel, xsize[i] taps
  int max_taps = 0;
};

FilterTaps build_taps(int in_size, int out_size) {
  FilterTaps t;
  const double scale = (double)in_size / out_size;
  const double fscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * fscale;  // triangle filter support
  t.xmin.resize(out_size);
  t.xsize.resize(out_size);
  const int max_taps = (int)std::ceil(support * 2) + 2;
  t.max_taps = max_taps;
  t.weights.assign((size_t)out_size * max_taps, 0.0f);
  for (int i = 0; i < out_size; i++) {
    double center = (i + 0.5) * scale;
    int lo = (int)(center - support + 0.5);
    int hi = (int)(center + support + 0.5);
    if (lo < 0) lo = 0;
    if (hi > in_size) hi = in_size;
    double sum = 0.0;
    for (int j = lo; j < hi; j++) {
      double d = (j - center + 0.5) / fscale;
      double w = d < 0 ? 1.0 + d : 1.0 - d;  // triangle
      if (w < 0) w = 0;
      t.weights[(size_t)i * max_taps + (j - lo)] = (float)w;
      sum += w;
    }
    if (sum > 0)
      for (int j = 0; j < hi - lo; j++)
        t.weights[(size_t)i * max_taps + j] /= (float)sum;
    t.xmin[i] = lo;
    t.xsize[i] = hi - lo;
  }
  return t;
}

void resize_normalize(const Image& img, int oh, int ow, float* dst) {
  const int c = img.c;
  if (img.h == oh && img.w == ow) {
    const size_t n = (size_t)oh * ow * c;
    for (size_t i = 0; i < n; i++) dst[i] = img.data[i] * (1.0f / 255.0f);
    return;
  }
  FilterTaps tx = build_taps(img.w, ow);
  FilterTaps ty = build_taps(img.h, oh);
  // horizontal pass: (H_in, W_out, C)
  std::vector<float> tmp((size_t)img.h * ow * c);
  for (int y = 0; y < img.h; y++) {
    const uint8_t* row = img.data.data() + (size_t)y * img.w * c;
    for (int x = 0; x < ow; x++) {
      const float* w = &tx.weights[(size_t)x * tx.max_taps];
      for (int k = 0; k < c; k++) {
        float acc = 0.0f;
        for (int j = 0; j < tx.xsize[x]; j++)
          acc += w[j] * row[(size_t)(tx.xmin[x] + j) * c + k];
        tmp[((size_t)y * ow + x) * c + k] = acc;
      }
    }
  }
  // vertical pass → normalize
  for (int y = 0; y < oh; y++) {
    const float* w = &ty.weights[(size_t)y * ty.max_taps];
    for (int x = 0; x < ow; x++) {
      for (int k = 0; k < c; k++) {
        float acc = 0.0f;
        for (int j = 0; j < ty.xsize[y]; j++)
          acc += w[j] * tmp[((size_t)(ty.xmin[y] + j) * ow + x) * c + k];
        dst[((size_t)y * ow + x) * c + k] = acc * (1.0f / 255.0f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode n frames into out (n, out_h, out_w, channels) float32 [0,1].
// Returns 0 on success; -(k+1) if path k failed.
int dvg_decode_batch(const char** paths, int n, int out_h, int out_w,
                     int channels, float* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);  // 0 = ok, else -(k+1)
  const size_t slot = (size_t)out_h * out_w * channels;

  auto worker = [&]() {
    Image img;
    for (;;) {
      int k = next.fetch_add(1);
      if (k >= n || failed.load()) return;
      bool ok = has_suffix(paths[k], ".jpg") || has_suffix(paths[k], ".jpeg")
                    ? decode_jpeg(paths[k], channels, &img)
                    : decode_png(paths[k], channels, &img);
      if (!ok) {
        int expect = 0;
        failed.compare_exchange_strong(expect, -(k + 1));
        return;
      }
      resize_normalize(img, out_h, out_w, out + (size_t)k * slot);
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load();
}

int dvg_version() { return 1; }

}  // extern "C"
