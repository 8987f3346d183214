// Native training data loader (the port's copy of the JAX package's
// kair_tpu/cpp/patch_loader.cpp) — the counterpart of the reference's torch
// DataLoader worker processes (main_train_psnr.py:116-145).
//
// What it does (entirely off the Python GIL, std::thread pool):
//   * holds images decoded by the caller (HWC uint8) in a RAM cache: the
//     machines the port runs on need not have libpng or libjpeg, so the
//     decoding is the port's own (kair_tpu_torch/data/native_loader.py)
//   * samples random patches, applies the 8-mode flip/rot augmentation
//     (same table as utils_image.augment_img, utils_image.py:387-404)
//   * converts uint8 -> float32 [0,1] and synthesises AWGN with a
//     per-thread xorshift128+ / Box-Muller generator (the DnCNN training
//     degradation, dataset_dncnn.py:70-75)
//   * builds the on-the-fly SR branch's LR cache by MATLAB bicubic
//
// Crop, augmentation, noise, bicubic and the random streams are the JAX
// package's, line for line, so both give the same batches from one seed.
// C ABI (ctypes-friendly); see kair_tpu_torch/data/native_loader.py.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC
};

struct FImage {
  int h = 0, w = 0, c = 0;
  std::vector<float> data;  // HWC, [0,1]-ish (bicubic ringing preserved)
};

// --------------------------------------------------------------- rng

struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed * 0x9E3779B97F4A7C15ULL + 1;
    s1 = (seed ^ 0xBF58476D1CE4E5B9ULL) | 1;
    for (int i = 0; i < 8; ++i) next();
  }
  uint64_t next() {  // xorshift128+
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  uint32_t below(uint32_t n) { return n ? static_cast<uint32_t>(next() % n) : 0; }
  float uniform() { return (next() >> 11) * (1.0f / 9007199254740992.0f); }
  float gauss() {  // Box-Muller
    float u1 = uniform(), u2 = uniform();
    if (u1 < 1e-12f) u1 = 1e-12f;
    return std::sqrt(-2.0f * std::log(u1)) * std::cos(6.2831853f * u2);
  }
};

// ------------------------------------------------- augmentation (8 modes)

// identical geometry table to utils_image.augment_img (utils_image.py:387);
// element-size-generic so the float L cache (bicubic SR) augments too
void augment_patch_g(const void* src_v, int ps, int c, int mode, void* dst_v,
                     size_t elem) {
  const char* src = static_cast<const char*>(src_v);
  char* dst = static_cast<char*>(dst_v);
  const size_t px = static_cast<size_t>(c) * elem;
  for (int y = 0; y < ps; ++y) {
    for (int x = 0; x < ps; ++x) {
      int sy = y, sx = x;
      switch (mode) {
        case 0: break;
        case 1: sy = x; sx = y; break;                    // flipud(rot90) = transpose
        case 2: sy = ps - 1 - y; sx = x; break;           // flipud
        case 3: sy = ps - 1 - x; sx = y; break;           // rot90 k=3
        case 4: sy = y; sx = ps - 1 - x; break;           // flipud(rot180)
        case 5: sy = x; sx = ps - 1 - y; break;           // rot90
        case 6: sy = ps - 1 - y; sx = ps - 1 - x; break;  // rot180
        case 7: sy = ps - 1 - x; sx = ps - 1 - y; break;  // flipud(rot270) = anti-transpose
      }
      std::memcpy(dst + (static_cast<size_t>(y) * ps + x) * px,
                  src + (static_cast<size_t>(sy) * ps + sx) * px, px);
    }
  }
}

void augment_patch(const uint8_t* src, int ps, int c, int mode, uint8_t* dst) {
  augment_patch_g(src, ps, c, mode, dst, 1);
}

// ----------------------------------------- MATLAB bicubic downscale
// Exact re-derivation of utils/image.py resize_weights/_cubic (reference
// utils_image.py:871-1014 / MATLAB imresize): antialiased cubic kernel,
// symmetric padding, double accumulation. Used to build the on-the-fly LR
// cache for the dataset_sr.py:66 train branch.

double cubic_kernel(double x) {
  double ax = std::fabs(x), ax2 = ax * ax, ax3 = ax2 * ax;
  if (ax <= 1.0) return 1.5 * ax3 - 2.5 * ax2 + 1.0;
  if (ax <= 2.0) return -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0;
  return 0.0;
}

struct AxisWeights {
  int taps = 0;                 // P after the zero-column trim
  int sym_s = 0, sym_e = 0;     // symmetric pad lengths
  std::vector<double> w;        // (out, taps)
  std::vector<int> idx;         // (out, taps), into the padded axis
};

AxisWeights resize_axis_weights(int in_len, int out_len, double scale) {
  // scale < 1, antialiasing on (the only mode the SR train branch uses)
  double kw = 4.0 / scale;
  int P = static_cast<int>(std::ceil(kw)) + 2;
  std::vector<double> w(static_cast<size_t>(out_len) * P);
  std::vector<double> ind(static_cast<size_t>(out_len) * P);
  for (int o = 0; o < out_len; ++o) {
    double u = (o + 1) / scale + 0.5 * (1.0 - 1.0 / scale);
    double left = std::floor(u - kw / 2.0);
    double sum = 0.0;
    for (int j = 0; j < P; ++j) {
      double pos = left + j;
      ind[static_cast<size_t>(o) * P + j] = pos;
      double v = scale * cubic_kernel((u - pos) * scale);
      w[static_cast<size_t>(o) * P + j] = v;
      sum += v;
    }
    for (int j = 0; j < P; ++j) w[static_cast<size_t>(o) * P + j] /= sum;
  }
  // zero-column trim, exactly as resize_weights (utils_image.py:919-926):
  // a zero anywhere in the first/last column drops it (P -> P-2)
  bool zero_first = false, zero_last = false;
  for (int o = 0; o < out_len; ++o) {
    if (w[static_cast<size_t>(o) * P] == 0.0) zero_first = true;
    if (w[static_cast<size_t>(o) * P + P - 1] == 0.0) zero_last = true;
  }
  int off = 0, taps = P;
  if (zero_first) { off = 1; taps = P - 2; }
  else if (zero_last) { taps = P - 2; }
  AxisWeights aw;
  aw.taps = taps;
  aw.w.resize(static_cast<size_t>(out_len) * taps);
  std::vector<double> tidx(static_cast<size_t>(out_len) * taps);
  double imin = 1e18, imax = -1e18;
  for (int o = 0; o < out_len; ++o)
    for (int j = 0; j < taps; ++j) {
      aw.w[static_cast<size_t>(o) * taps + j] =
          w[static_cast<size_t>(o) * P + off + j];
      double pos = ind[static_cast<size_t>(o) * P + off + j];
      tidx[static_cast<size_t>(o) * taps + j] = pos;
      imin = std::min(imin, pos);
      imax = std::max(imax, pos);
    }
  aw.sym_s = static_cast<int>(-imin + 1);
  aw.sym_e = static_cast<int>(imax - in_len);
  aw.idx.resize(tidx.size());
  for (size_t k = 0; k < tidx.size(); ++k)
    aw.idx[k] = static_cast<int>(tidx[k]) + aw.sym_s - 1;
  return aw;
}

// symmetric-pad index mapping: padded index -> source row (axis length n)
inline int sym_src(int p, int s, int n) {
  if (p < s) return s - 1 - p;           // reversed first s rows
  if (p < s + n) return p - s;
  return n - 1 - (p - s - n);            // reversed last e rows
}

// out: (out_h, out_w, c) float; in: uint8 HWC (values /255 like uint2single)
void bicubic_downscale(const uint8_t* in, int h, int w, int c, int sf,
                       float* out) {
  double scale = 1.0 / sf;
  int oh = (h + sf - 1) / sf, ow = (w + sf - 1) / sf;  // ceil(h*scale)
  AxisWeights ah = resize_axis_weights(h, oh, scale);
  AxisWeights aww = resize_axis_weights(w, ow, scale);
  // pass 1: H axis -> (oh, w, c) double
  std::vector<double> t1(static_cast<size_t>(oh) * w * c);
  for (int o = 0; o < oh; ++o) {
    const double* wr = ah.w.data() + static_cast<size_t>(o) * ah.taps;
    const int* ir = ah.idx.data() + static_cast<size_t>(o) * ah.taps;
    double* dst = t1.data() + static_cast<size_t>(o) * w * c;
    std::memset(dst, 0, sizeof(double) * w * c);
    for (int j = 0; j < ah.taps; ++j) {
      int sy = sym_src(ir[j], ah.sym_s, h);
      const uint8_t* src = in + static_cast<size_t>(sy) * w * c;
      double wj = wr[j] * (1.0 / 255.0);
      for (int k = 0; k < w * c; ++k) dst[k] += wj * src[k];
    }
  }
  // pass 2: W axis -> (oh, ow, c) float
  for (int o = 0; o < ow; ++o) {
    const double* wr = aww.w.data() + static_cast<size_t>(o) * aww.taps;
    const int* ir = aww.idx.data() + static_cast<size_t>(o) * aww.taps;
    for (int y = 0; y < oh; ++y) {
      const double* row = t1.data() + static_cast<size_t>(y) * w * c;
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int j = 0; j < aww.taps; ++j)
          acc += wr[j] * row[static_cast<size_t>(sym_src(ir[j], aww.sym_s, w))
                             * c + ch];
        out[(static_cast<size_t>(y) * ow + o) * c + ch] =
            static_cast<float>(acc);
      }
    }
  }
}

// ------------------------------------------------------------- loader

struct Loader {
  std::vector<Image> images;
  int n_channels = 1;
  int n_threads = 4;
};

void parallel_for(int n_threads, int n_items,
                  const std::function<void(int, int)>& fn) {
  std::vector<std::thread> threads;
  std::atomic<int> next(0);
  int t_count = std::min(n_threads, n_items);
  for (int t = 0; t < t_count; ++t) {
    threads.emplace_back([&, t]() {
      int i;
      while ((i = next.fetch_add(1)) < n_items) fn(i, t);
    });
  }
  for (auto& th : threads) th.join();
}

// one decoded HWC uint8 image into the cache (shape: h, w, c)
bool fill_image(const uint8_t* data, const int* shape, int want_c,
                Image* out) {
  if (!data || shape[0] <= 0 || shape[1] <= 0 || shape[2] != want_c)
    return false;
  out->h = shape[0];
  out->w = shape[1];
  out->c = shape[2];
  out->data.assign(data, data + static_cast<size_t>(out->h) * out->w * out->c);
  return true;
}

}  // namespace

extern "C" {

// Copy `n` decoded images (images[i]: HWC uint8, shapes[3i..3i+2] = h, w,
// c, c == n_channels) into a RAM cache. Returns handle or null.
void* loader_create(const uint8_t** images, const int* shapes, int n,
                    int n_channels, int n_threads) {
  auto* L = new Loader;
  L->n_channels = n_channels;
  L->n_threads = n_threads;
  L->images.resize(n);
  std::atomic<bool> ok(true);
  parallel_for(n_threads, n, [&](int i, int) {
    if (!fill_image(images[i], shapes + 3 * i, n_channels, &L->images[i]))
      ok = false;
  });
  if (!ok) {
    delete L;
    return nullptr;
  }
  return L;
}

int loader_num_images(void* handle) {
  return static_cast<int>(static_cast<Loader*>(handle)->images.size());
}

int loader_image_shape(void* handle, int idx, int* h, int* w, int* c) {
  auto* L = static_cast<Loader*>(handle);
  if (idx < 0 || idx >= static_cast<int>(L->images.size())) return -1;
  *h = L->images[idx].h;
  *w = L->images[idx].w;
  *c = L->images[idx].c;
  return 0;
}

// Sample a batch of AWGN training pairs:
//   out_H, out_L: float32 [batch, ps, ps, C] buffers (caller-allocated)
// Per item: random image, random crop, random 8-mode augmentation,
// L = H + sigma/255 * N(0,1) (the dataset_dncnn.py:60-75 pipeline).
int loader_sample_awgn_batch(void* handle, int batch, int ps, float sigma,
                             uint64_t seed, float* out_L, float* out_H) {
  auto* L = static_cast<Loader*>(handle);
  const int c = L->n_channels;
  const float nl = sigma / 255.0f;
  std::atomic<bool> ok(true);
  parallel_for(L->n_threads, batch, [&](int i, int) {
    Rng rng(seed + 0x5851F42D4C957F2DULL * (i + 1));
    const Image& img = L->images[rng.below(L->images.size())];
    if (img.h < ps || img.w < ps) {
      ok = false;
      return;
    }
    int ry = rng.below(img.h - ps + 1);
    int rx = rng.below(img.w - ps + 1);
    // crop into a contiguous patch
    std::vector<uint8_t> crop(static_cast<size_t>(ps) * ps * c);
    for (int y = 0; y < ps; ++y)
      std::memcpy(crop.data() + static_cast<size_t>(y) * ps * c,
                  img.data.data() +
                      ((static_cast<size_t>(ry) + y) * img.w + rx) * c,
                  static_cast<size_t>(ps) * c);
    std::vector<uint8_t> aug(crop.size());
    augment_patch(crop.data(), ps, c, rng.below(8), aug.data());

    float* h_dst = out_H + static_cast<size_t>(i) * ps * ps * c;
    float* l_dst = out_L + static_cast<size_t>(i) * ps * ps * c;
    const float inv255 = 1.0f / 255.0f;
    for (size_t k = 0; k < aug.size(); ++k) {
      float v = aug[k] * inv255;
      h_dst[k] = v;
      l_dst[k] = v + nl * rng.gauss();
    }
  });
  return ok ? 0 : -1;
}

// Like loader_sample_awgn_batch but with a per-item noise level drawn
// uniformly from [sigma_min, sigma_max] (the dataset_fdncnn.py /
// dataset_ffdnet.py train protocol); the drawn level (already /255) is
// written to out_level[i] so the python side can build the conditioning
// channel (H x W map for FDnCNN, scalar C for FFDNet).
int loader_sample_awgn_range_batch(void* handle, int batch, int ps,
                                   float sigma_min, float sigma_max,
                                   uint64_t seed, float* out_L, float* out_H,
                                   float* out_level) {
  auto* L = static_cast<Loader*>(handle);
  const int c = L->n_channels;
  std::atomic<bool> ok(true);
  parallel_for(L->n_threads, batch, [&](int i, int) {
    Rng rng(seed + 0x5851F42D4C957F2DULL * (i + 1));
    const Image& img = L->images[rng.below(L->images.size())];
    if (img.h < ps || img.w < ps) {
      ok = false;
      return;
    }
    int ry = rng.below(img.h - ps + 1);
    int rx = rng.below(img.w - ps + 1);
    std::vector<uint8_t> crop(static_cast<size_t>(ps) * ps * c);
    for (int y = 0; y < ps; ++y)
      std::memcpy(crop.data() + static_cast<size_t>(y) * ps * c,
                  img.data.data() +
                      ((static_cast<size_t>(ry) + y) * img.w + rx) * c,
                  static_cast<size_t>(ps) * c);
    std::vector<uint8_t> aug(crop.size());
    augment_patch(crop.data(), ps, c, rng.below(8), aug.data());

    const float nl =
        (sigma_min + rng.uniform() * (sigma_max - sigma_min)) / 255.0f;
    out_level[i] = nl;
    float* h_dst = out_H + static_cast<size_t>(i) * ps * ps * c;
    float* l_dst = out_L + static_cast<size_t>(i) * ps * ps * c;
    const float inv255 = 1.0f / 255.0f;
    for (size_t k = 0; k < aug.size(); ++k) {
      float v = aug[k] * inv255;
      h_dst[k] = v;
      l_dst[k] = v + nl * rng.gauss();
    }
  });
  return ok ? 0 : -1;
}

// Expose the augmentation table for mode-indexed parity tests against
// utils_image.augment_img (the geometry must match exactly for seeded
// python-batch reproduction and x8-ensemble parity).
void loader_augment(const uint8_t* src, int ps, int c, int mode,
                    uint8_t* dst) {
  augment_patch(src, ps, c, mode, dst);
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// ------------------------------------------------ paired SR loader
// The dataset_sr train protocol (kair_tpu/data/datasets.py DatasetSR,
// reference data/dataset_sr.py): random L crop of l_ps, the aligned H crop
// at (ry*sf, rx*sf) of l_ps*sf, the SAME 8-mode augmentation on both.
// Pre-generated LR images, or the on-the-fly bicubic branch below.

struct PairLoader {
  std::vector<Image> l, h;
  std::vector<FImage> lf;   // float LR cache (on-the-fly bicubic mode)
  bool l_is_float = false;
  int n_channels = 3;
  int n_threads = 4;
};

void* pair_loader_create(const uint8_t** images_l, const int* shapes_l,
                         const uint8_t** images_h, const int* shapes_h, int n,
                         int n_channels, int n_threads) {
  auto* P = new PairLoader;
  P->n_channels = n_channels;
  P->n_threads = n_threads;
  P->l.resize(n);
  P->h.resize(n);
  std::atomic<bool> ok(true);
  parallel_for(n_threads, 2 * n, [&](int i, int) {
    bool filled = i < n
        ? fill_image(images_l[i], shapes_l + 3 * i, n_channels, &P->l[i])
        : fill_image(images_h[i - n], shapes_h + 3 * (i - n), n_channels,
                     &P->h[i - n]);
    if (!filled) ok = false;
  });
  if (!ok) {
    delete P;
    return nullptr;
  }
  return P;
}

// On-the-fly bicubic SR cache (the dataset_sr.py:66 train branch when no
// dataroot_L exists): H, modcrop to a multiple of sf, MATLAB-bicubic
// downscale ONCE at build time into a float LR cache — per-batch work is
// then only crop + augment, same as the pre-generated-LR mode.
void* pair_loader_create_bicubic(const uint8_t** images_h,
                                 const int* shapes_h, int n, int n_channels,
                                 int sf, int n_threads) {
  auto* P = new PairLoader;
  P->n_channels = n_channels;
  P->n_threads = n_threads;
  P->l_is_float = true;
  P->h.resize(n);
  P->lf.resize(n);
  std::atomic<bool> ok(true);
  parallel_for(n_threads, n, [&](int i, int) {
    Image img;
    if (!fill_image(images_h[i], shapes_h + 3 * i, n_channels, &img)) {
      ok = false;
      return;
    }
    // modcrop (utils_image.modcrop): crop to floor(dim/sf)*sf
    int ch = (img.h / sf) * sf, cw = (img.w / sf) * sf;
    if (ch == 0 || cw == 0) {
      ok = false;
      return;
    }
    Image& H = P->h[i];
    H.h = ch; H.w = cw; H.c = img.c;
    H.data.resize(static_cast<size_t>(ch) * cw * img.c);
    for (int y = 0; y < ch; ++y)
      std::memcpy(H.data.data() + static_cast<size_t>(y) * cw * img.c,
                  img.data.data() + static_cast<size_t>(y) * img.w * img.c,
                  static_cast<size_t>(cw) * img.c);
    FImage& Lf = P->lf[i];
    Lf.h = ch / sf; Lf.w = cw / sf; Lf.c = img.c;
    Lf.data.resize(static_cast<size_t>(Lf.h) * Lf.w * Lf.c);
    bicubic_downscale(H.data.data(), ch, cw, img.c, sf, Lf.data.data());
  });
  if (!ok) {
    delete P;
    return nullptr;
  }
  return P;
}

int pair_loader_num(void* handle) {
  auto* P = static_cast<PairLoader*>(handle);
  return static_cast<int>(P->l_is_float ? P->lf.size() : P->l.size());
}

// Direct bicubic-downscale entry for parity tests vs utils.image.imresize_np
// (in: uint8 HWC; out: float32 (ceil(h/sf), ceil(w/sf), c)).
void bicubic_downscale_u8(const uint8_t* in, int h, int w, int c, int sf,
                          float* out) {
  bicubic_downscale(in, h, w, c, sf, out);
}

// out_L: float32 [batch, l_ps, l_ps, C];  out_H: [batch, l_ps*sf, .., C]
int pair_loader_sample_sr_batch(void* handle, int batch, int l_ps, int sf,
                                uint64_t seed, float* out_L, float* out_H) {
  auto* P = static_cast<PairLoader*>(handle);
  const int c = P->n_channels;
  const int h_ps = l_ps * sf;
  std::atomic<bool> ok(true);
  parallel_for(P->n_threads, batch, [&](int i, int) {
    Rng rng(seed + 0x5851F42D4C957F2DULL * (i + 1));
    uint32_t n_img = static_cast<uint32_t>(P->l_is_float ? P->lf.size()
                                                         : P->l.size());
    uint32_t idx = rng.below(n_img);
    const Image& ih = P->h[idx];
    int lh = P->l_is_float ? P->lf[idx].h : P->l[idx].h;
    int lw = P->l_is_float ? P->lf[idx].w : P->l[idx].w;
    if (lh < l_ps || lw < l_ps) {
      ok = false;
      return;
    }
    int ry = rng.below(lh - l_ps + 1);
    int rx = rng.below(lw - l_ps + 1);
    if (ih.h < (ry + l_ps) * sf || ih.w < (rx + l_ps) * sf) {
      ok = false;  // H smaller than sf x L (pairs must be size-consistent)
      return;
    }
    int mode = rng.below(8);

    auto crop_aug_u8 = [&](const Image& img, int y0, int x0, int ps,
                           float* dst) {
      std::vector<uint8_t> crop(static_cast<size_t>(ps) * ps * c);
      for (int y = 0; y < ps; ++y)
        std::memcpy(crop.data() + static_cast<size_t>(y) * ps * c,
                    img.data.data() +
                        ((static_cast<size_t>(y0) + y) * img.w + x0) * c,
                    static_cast<size_t>(ps) * c);
      std::vector<uint8_t> aug(crop.size());
      augment_patch(crop.data(), ps, c, mode, aug.data());
      const float inv255 = 1.0f / 255.0f;
      for (size_t k = 0; k < aug.size(); ++k) dst[k] = aug[k] * inv255;
    };
    auto crop_aug_f32 = [&](const FImage& img, int y0, int x0, int ps,
                            float* dst) {
      std::vector<float> crop(static_cast<size_t>(ps) * ps * c);
      for (int y = 0; y < ps; ++y)
        std::memcpy(crop.data() + static_cast<size_t>(y) * ps * c,
                    img.data.data() +
                        ((static_cast<size_t>(y0) + y) * img.w + x0) * c,
                    static_cast<size_t>(ps) * c * sizeof(float));
      augment_patch_g(crop.data(), ps, c, mode, dst, sizeof(float));
    };
    if (P->l_is_float)
      crop_aug_f32(P->lf[idx], ry, rx, l_ps,
                   out_L + static_cast<size_t>(i) * l_ps * l_ps * c);
    else
      crop_aug_u8(P->l[idx], ry, rx, l_ps,
                  out_L + static_cast<size_t>(i) * l_ps * l_ps * c);
    crop_aug_u8(ih, ry * sf, rx * sf, h_ps,
                out_H + static_cast<size_t>(i) * h_ps * h_ps * c);
  });
  return ok ? 0 : -1;
}

void pair_loader_destroy(void* handle) {
  delete static_cast<PairLoader*>(handle);
}

}  // extern "C"
