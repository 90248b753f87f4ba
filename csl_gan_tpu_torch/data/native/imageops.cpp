// Native (C++) image pipeline for the decode-once CelebA cache of the
// PyTorch port (csl_gan_tpu_torch/data/celeba.py decoded_cache): the port's
// own copy of the JAX package's decoder, the same function on the same
// files.
//
// The reference decodes with PIL in torch DataLoader workers every epoch
// (reference datasets.py:44-54, init_util.py:30-42). The port decodes the
// dataset ONCE into a uint8 cache that the Trainer uploads to the card
// (augmentation runs there), so the host cost that matters is the one-off
// decode + resize + crop over ~200k JPEGs:
//
//   - libjpeg decode (the library PIL wraps, default ISLOW IDCT, so pixels
//     match PIL's decode bit for bit),
//   - PIL-compatible separable triangle-filter resample ("bilinear" with
//     the support scaled by the downsampling ratio; plain texel bilinear
//     would alias on CelebA's ~3.4x downscale),
//   - centre crop to im_size x im_size,
//   - a std::thread pool over images.
//
// A C ABI for ctypes (csl_gan_tpu_torch/data/native/__init__.py); no Python
// dependency in this translation unit.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file to RGB8. Returns false on any decode error.
bool decode_jpeg(const char* path, std::vector<uint8_t>* rgb,
                 int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // PIL convert("RGB") equivalent
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// One axis of PIL's convolution resampling (Resampling.BILINEAR): a
// triangle filter whose support is scaled by max(1, in/out). Weights are
// PIL's exact fixed-point-free double math with the final rounding.
struct ResampleAxis {
  int ksize;                 // taps per output pixel
  std::vector<int> bounds;   // [out] first input pixel
  std::vector<double> kk;    // [out * ksize] weights
};

double triangle(double x) {
  if (x < 0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

ResampleAxis precompute(int in_size, int out_size) {
  ResampleAxis ax;
  double scale = double(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // triangle filter support = 1
  ax.ksize = int(std::ceil(support)) * 2 + 1;
  ax.bounds.resize(out_size);
  ax.kk.assign(size_t(out_size) * ax.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5)) - xmin;
    double* k = &ax.kk[size_t(xx) * ax.ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = triangle((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    ax.bounds[xx] = xmin;
    for (int x = xmax; x < ax.ksize; ++x) k[x] = 0.0;
  }
  return ax;
}

inline uint8_t clip8(double v) {
  long r = std::lround(v);
  return uint8_t(std::min(255l, std::max(0l, r)));
}

// Separable resample RGB8 HWC: horizontal pass (double intermediate),
// then vertical pass, matching PIL's two-pass structure.
void resample(const uint8_t* src, int sw, int sh,
              uint8_t* dst, int dw, int dh) {
  ResampleAxis hx = precompute(sw, dw);
  ResampleAxis vx = precompute(sh, dh);
  std::vector<double> tmp(size_t(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + size_t(y) * sw * 3;
    double* trow = &tmp[size_t(y) * dw * 3];
    for (int x = 0; x < dw; ++x) {
      const double* k = &hx.kk[size_t(x) * hx.ksize];
      int x0 = hx.bounds[x];
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < hx.ksize; ++i) {
        int xi = x0 + i;
        if (xi >= sw) break;
        const uint8_t* p = srow + size_t(xi) * 3;
        r += p[0] * k[i];
        g += p[1] * k[i];
        b += p[2] * k[i];
      }
      trow[x * 3 + 0] = r;
      trow[x * 3 + 1] = g;
      trow[x * 3 + 2] = b;
    }
  }
  for (int y = 0; y < dh; ++y) {
    const double* k = &vx.kk[size_t(y) * vx.ksize];
    int y0 = vx.bounds[y];
    uint8_t* drow = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      double acc = 0;
      for (int i = 0; i < vx.ksize; ++i) {
        int yi = y0 + i;
        if (yi >= sh) break;
        acc += tmp[size_t(yi) * dw * 3 + x] * k[i];
      }
      drow[x] = clip8(acc);
    }
  }
}

// decode -> resize shorter side to im_size (same rounding as
// data/celeba.py _decode) -> center crop im_size x im_size.
bool process_one(const char* path, int im_size, uint8_t* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(path, &rgb, &w, &h)) return false;
  double scale = double(im_size) / std::min(w, h);
  int rw = std::max(im_size, int(std::lround(w * scale)));
  int rh = std::max(im_size, int(std::lround(h * scale)));
  std::vector<uint8_t> resized(size_t(rw) * rh * 3);
  resample(rgb.data(), w, h, resized.data(), rw, rh);
  int left = (rw - im_size) / 2, top = (rh - im_size) / 2;
  for (int y = 0; y < im_size; ++y)
    std::memcpy(out + size_t(y) * im_size * 3,
                resized.data() + (size_t(top + y) * rw + left) * 3,
                size_t(im_size) * 3);
  return true;
}

}  // namespace

extern "C" {

// Decode `n` JPEGs (NUL-separated `paths` buffer) into `out`
// [n, im_size, im_size, 3] uint8 using `n_threads` workers.
// Returns the number of successfully processed images; `ok[i]` is 1/0.
int csl_decode_batch(const char* paths, int n, int im_size,
                     uint8_t* out, uint8_t* ok, int n_threads) {
  std::vector<const char*> files(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    files[i] = p;
    p += std::strlen(p) + 1;
  }
  size_t stride = size_t(im_size) * im_size * 3;
  std::atomic<int> next(0), good(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      bool s = process_one(files[i], im_size, out + stride * i);
      ok[i] = s ? 1 : 0;
      if (s) good.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return good.load();
}

// Standalone PIL-compatible resample (RGB8 HWC), exposed for parity tests.
void csl_resample(const uint8_t* src, int sw, int sh,
                  uint8_t* dst, int dw, int dh) {
  resample(src, sw, sh, dst, dw, dh);
}

}  // extern "C"
