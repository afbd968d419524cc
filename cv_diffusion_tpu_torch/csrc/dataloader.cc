// Native data pipeline: threaded image decode + paired augmentation + batch
// assembly.
//
// The port's copy of the JAX package's native/dataloader.cc, unchanged in
// behaviour: one GIL-free C++ library that decodes PNG/JPEG with
// libpng/libjpeg, applies the paired geometric augmentation (random crop ->
// hflip p=.5 -> vflip p=.3 -> rotate +-15deg p=.3 with bilinear sampling and
// reflect-101 borders), normalizes to [-1, 1] float32 NHWC, and fills
// caller-provided batch buffers in parallel worker threads.  Exposed through
// a plain C ABI for ctypes (cv_diffusion_tpu_torch/data/native.py), built at
// first use with one g++ call (ops/cuda_build.py::build_host).
//
// Determinism: a splitmix64 stream seeded with (seed, item_index) drives all
// per-item randomness, so a batch is reproducible given its seed regardless
// of thread scheduling.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

namespace {

// ----------------------------------------------------------------- RNG
struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97f4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double lo, double hi) { return lo + uniform() * (hi - lo); }
  int64_t randint(int64_t lo, int64_t hi) {  // [lo, hi)
    return lo + static_cast<int64_t>(uniform() * (hi - lo));
  }
  // standard normal via Box-Muller
  double normal() {
    double u1 = uniform();
    double u2 = uniform();
    if (u1 < 1e-300) u1 = 1e-300;
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(2.0 * M_PI * u2);
  }
};

// ----------------------------------------------------------------- image
struct Image {
  std::vector<uint8_t> data;  // HWC RGB8
  int h = 0, w = 0;
};

bool has_suffix(const std::string& s, const char* suf) {
  std::string lower(s);
  std::transform(lower.begin(), lower.end(), lower.begin(), ::tolower);
  size_t n = std::strlen(suf);
  return lower.size() >= n && lower.compare(lower.size() - n, n, suf) == 0;
}

bool decode_png(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { std::fclose(fp); return false; }
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr);
               std::fclose(fp); return false; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // Normalize to 8-bit RGB.
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA ||
      png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->data.resize(static_cast<size_t>(h) * w * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data.data() + static_cast<size_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(static_cast<size_t>(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out->data.data() + static_cast<size_t>(cinfo.output_scanline) *
                               out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

bool decode_image(const char* path, Image* out) {
  std::string p(path);
  if (has_suffix(p, ".png")) return decode_png(path, out);
  if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg"))
    return decode_jpeg(path, out);
  // try both
  return decode_png(path, out) || decode_jpeg(path, out);
}

// ------------------------------------------------------------- transforms
inline int reflect101(int i, int n) {
  // OpenCV BORDER_REFLECT_101: ...2 1 | 0 1 2 ... n-1 | n-2 n-3...
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// Rotate about the image center (cv2.getRotationMatrix2D convention with
// center (w/2-0.5, h/2-0.5)), bilinear, reflect-101 borders.
void rotate_u8(const uint8_t* src, int h, int w, double angle_deg,
               uint8_t* dst) {
  const double a = angle_deg * M_PI / 180.0;
  const double ca = std::cos(a), sa = std::sin(a);
  const double cx = w / 2.0 - 0.5, cy = h / 2.0 - 0.5;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      // inverse map (dst -> src): rotate by -angle about center
      const double dx = x - cx, dy = y - cy;
      const double sx = ca * dx - sa * dy + cx;
      const double sy = sa * dx + ca * dy + cy;
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      const double fx = sx - x0, fy = sy - y0;
      const int x0r = reflect101(x0, w), x1r = reflect101(x0 + 1, w);
      const int y0r = reflect101(y0, h), y1r = reflect101(y0 + 1, h);
      for (int c = 0; c < 3; ++c) {
        const double v00 = src[(static_cast<size_t>(y0r) * w + x0r) * 3 + c];
        const double v01 = src[(static_cast<size_t>(y0r) * w + x1r) * 3 + c];
        const double v10 = src[(static_cast<size_t>(y1r) * w + x0r) * 3 + c];
        const double v11 = src[(static_cast<size_t>(y1r) * w + x1r) * 3 + c];
        const double v = v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) +
                         v10 * (1 - fx) * fy + v11 * fx * fy;
        dst[(static_cast<size_t>(y) * w + x) * 3 + c] =
            static_cast<uint8_t>(std::lround(std::clamp(v, 0.0, 255.0)));
      }
    }
  }
}

// crop + optional flips from a source image into a contiguous u8 buffer
void crop_flip(const uint8_t* src, int sh, int sw, int top, int left,
               int size, bool hflip, bool vflip, uint8_t* dst) {
  for (int y = 0; y < size; ++y) {
    const int sy = top + (vflip ? (size - 1 - y) : y);
    const uint8_t* srow = src + (static_cast<size_t>(sy) * sw + left) * 3;
    uint8_t* drow = dst + static_cast<size_t>(y) * size * 3;
    if (!hflip) {
      std::memcpy(drow, srow, static_cast<size_t>(size) * 3);
    } else {
      for (int x = 0; x < size; ++x) {
        const uint8_t* s = srow + (size - 1 - x) * 3;
        drow[x * 3 + 0] = s[0];
        drow[x * 3 + 1] = s[1];
        drow[x * 3 + 2] = s[2];
      }
    }
  }
}

void normalize_to(const uint8_t* src, int n, float* dst) {
  // (x/255 - .5)/.5 — keep the exact two-step form so 255 maps to 1.0f
  // exactly (a single 1/127.5f multiplier rounds 255 to 1.0000001f).
  for (int i = 0; i < n; ++i)
    dst[i] = (src[i] / 255.0f - 0.5f) * 2.0f;
}

// One paired item: decode both, same geometric transform, normalize.
bool process_pair(const char* low_path, const char* high_path, int size,
                  uint64_t seed, bool augment, float* out_low,
                  float* out_high) {
  Image low, high;
  if (!decode_image(low_path, &low)) return false;
  if (!decode_image(high_path, &high)) return false;
  const int h = std::min(low.h, high.h);
  const int w = std::min(low.w, high.w);
  if (h < size || w < size) return false;

  SplitMix64 rng(seed);
  int top, left;
  bool hflip = false, vflip = false;
  double angle = 0.0;
  if (augment) {
    top = static_cast<int>(rng.randint(0, h - size + 1));
    left = static_cast<int>(rng.randint(0, w - size + 1));
    hflip = rng.uniform() < 0.5;
    vflip = rng.uniform() < 0.3;
    if (rng.uniform() < 0.3) angle = rng.uniform(-15.0, 15.0);
  } else {
    top = (h - size) / 2;
    left = (w - size) / 2;
  }

  std::vector<uint8_t> buf(static_cast<size_t>(size) * size * 3);
  std::vector<uint8_t> rot(angle != 0.0 ? buf.size() : 0);
  const int n = size * size * 3;

  crop_flip(low.data.data(), low.h, low.w, top, left, size, hflip, vflip,
            buf.data());
  if (angle != 0.0) {
    rotate_u8(buf.data(), size, size, angle, rot.data());
    normalize_to(rot.data(), n, out_low);
  } else {
    normalize_to(buf.data(), n, out_low);
  }

  crop_flip(high.data.data(), high.h, high.w, top, left, size, hflip, vflip,
            buf.data());
  if (angle != 0.0) {
    rotate_u8(buf.data(), size, size, angle, rot.data());
    normalize_to(rot.data(), n, out_high);
  } else {
    normalize_to(buf.data(), n, out_high);
  }
  return true;
}

// Synthetic degradation (src/training/dataset.py:286-308): crop+hflip the
// normal image, then gamma-darken + gaussian noise + 50% color scale.
bool process_synth(const char* path, int size, uint64_t seed, float gamma_lo,
                   float gamma_hi, float noise_lo, float noise_hi,
                   float* out_low, float* out_high) {
  Image img;
  if (!decode_image(path, &img)) return false;
  if (img.h < size || img.w < size) return false;
  SplitMix64 rng(seed);
  const int top = static_cast<int>(rng.randint(0, img.h - size + 1));
  const int left = static_cast<int>(rng.randint(0, img.w - size + 1));
  const bool hflip = rng.uniform() < 0.5;

  std::vector<uint8_t> normal(static_cast<size_t>(size) * size * 3);
  crop_flip(img.data.data(), img.h, img.w, top, left, size, hflip, false,
            normal.data());

  const double gamma = rng.uniform(gamma_lo, gamma_hi);
  const double noise_level = rng.uniform(noise_lo, noise_hi);
  const bool color_shift = rng.uniform() < 0.5;
  double scale[3] = {1.0, 1.0, 1.0};
  if (color_shift)
    for (double& s : scale) s = rng.uniform(0.8, 1.0);

  const int n = size * size * 3;
  // gamma LUT
  float lut[256];
  for (int i = 0; i < 256; ++i)
    lut[i] = static_cast<float>(std::pow(i / 255.0, gamma));
  for (int i = 0; i < n; ++i) {
    double v = lut[normal[i]] + rng.normal() * noise_level;
    v = std::clamp(v, 0.0, 1.0) * scale[i % 3];
    v = std::clamp(v, 0.0, 1.0);
    // quantize to u8 like the reference ((noisy*255).astype(uint8)), then
    // normalize
    const uint8_t u = static_cast<uint8_t>(v * 255.0);
    out_low[i] = (u / 255.0f - 0.5f) * 2.0f;
    out_high[i] = (normal[i] / 255.0f - 0.5f) * 2.0f;
  }
  return true;
}

void parallel_for(int n, int num_threads, const std::function<void(int)>& fn) {
  if (num_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) fn(i);
  };
  std::vector<std::thread> threads;
  const int t = std::min(num_threads, n);
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Decode one image file to RGB8. Caller provides a buffer of cap bytes;
// returns 0 on success and writes h/w. Returns -2 if cap is too small
// (h/w are still written so the caller can retry).
int cvdm_decode_image(const char* path, uint8_t* out, long cap, int* h,
                      int* w) {
  Image img;
  if (!decode_image(path, &img)) return -1;
  *h = img.h;
  *w = img.w;
  const long need = static_cast<long>(img.data.size());
  if (need > cap) return -2;
  std::memcpy(out, img.data.data(), img.data.size());
  return 0;
}

// Load a paired batch: n items, each decoded + augmented into
// out_low/out_high ([n, size, size, 3] float32, caller-allocated).
// failed[i] = 1 for items that could not be processed (left zeroed).
int cvdm_load_pair_batch(const char** low_paths, const char** high_paths,
                         int n, int size, uint64_t seed, int augment,
                         int num_threads, float* out_low, float* out_high,
                         uint8_t* failed) {
  const size_t item = static_cast<size_t>(size) * size * 3;
  std::atomic<int> nfail(0);
  parallel_for(n, num_threads, [&](int i) {
    const bool ok = process_pair(
        low_paths[i], high_paths[i], size, seed * 0x9E3779B97f4A7C15ull + i,
        augment != 0, out_low + item * i, out_high + item * i);
    failed[i] = ok ? 0 : 1;
    if (!ok) {
      std::memset(out_low + item * i, 0, item * sizeof(float));
      std::memset(out_high + item * i, 0, item * sizeof(float));
      nfail.fetch_add(1);
    }
  });
  return nfail.load();
}

// Synthetic low-light batch from normal-light images.
int cvdm_load_synth_batch(const char** paths, int n, int size, uint64_t seed,
                          float gamma_lo, float gamma_hi, float noise_lo,
                          float noise_hi, int num_threads, float* out_low,
                          float* out_high, uint8_t* failed) {
  const size_t item = static_cast<size_t>(size) * size * 3;
  std::atomic<int> nfail(0);
  parallel_for(n, num_threads, [&](int i) {
    const bool ok = process_synth(
        paths[i], size, seed * 0x9E3779B97f4A7C15ull + i, gamma_lo, gamma_hi,
        noise_lo, noise_hi, out_low + item * i, out_high + item * i);
    failed[i] = ok ? 0 : 1;
    if (!ok) {
      std::memset(out_low + item * i, 0, item * sizeof(float));
      std::memset(out_high + item * i, 0, item * sizeof(float));
      nfail.fetch_add(1);
    }
  });
  return nfail.load();
}

// Rotation exported on its own so Python tests can assert geometric parity
// with the cv2.warpAffine path (same center/inverse-map/reflect-101
// convention) — the batch entry points only expose it composed with random
// crop/flip, which a cross-pipeline test cannot isolate.
int cvdm_rotate_u8(const uint8_t* src, int h, int w, double angle_deg,
                   uint8_t* dst) {
  if (h <= 0 || w <= 0) return -1;
  rotate_u8(src, h, w, angle_deg, dst);
  return 0;
}

int cvdm_version() { return 1; }

}  // extern "C"
