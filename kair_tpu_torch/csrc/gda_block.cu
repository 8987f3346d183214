// Guided deformable attention (GDA), inference, bf16 in, f32 sums (sm_90a).
//
// Replaces kair_tpu/ops/pallas/gda_block.py :: gda_fused (the pl.pallas_call
// of _fused_fwd_impl, body _gda_kernel), RVRT's alignment
// (models/rvrt.py GuidedDeformAttnPack; KAIR deform_attn_cuda_pt110.cpp:
// 64-120). For each query pixel p of frame j and head g (a head is a
// deformable group: heads == groups, every released RVRT):
//
//   for s = (n, k) in S = clip x kh x kw taps:
//     pos_s   = p + (k / kw - kh / 2, k % kw - kw / 2) + off[p, n, g, k]
//     k_s,v_s = bilinear(k / v of KV frame (n + j) % clip, group g, pos_s)
//     score_s = scale * q[p, g] . k_s
//   out[p, g] = sum_s softmax_s(score) v_s
//
// with zeros padding (a corner outside the frame reads 0, so a tap wholly
// outside scores against a zero key) and the JAX package's offset layout
// (.., clip, H, W, dg, K, 2), y first. The KV clip is read un-rotated: the
// (n + j) % clip pairing of query frame j with KV slot n is in the indices,
// so no rotated copy of k and v is made (kair_tpu/models/rvrt.py:159-166
// stacks two).
//
// Bound on the H100: at RVRT-001's call shape (q 2x64x64x288, K/V 1x2x64x
// 64x288 bf16, 12 groups of 24 channels, S = 18) one call moves about 33 MB
// (q, k, v and the output in bf16, the f32 offsets: 14.2 MB of them) and does
// about 0.85 GFLOP of f32 CUDA-core work (two bilinear samples, a dot and an
// accumulate per channel and tap): ~9.9 us of memory, ~12.7 us at the f32
// rate of 67 TFLOP/s. In practice the gather bounds it, in issued
// instructions more than in bytes: every sampled value costs an unpack and
// an FMA per corner, beside the corners' addressing, and 4 corners x (k + v)
// x 48 bytes x 18 taps x 98,304 (pixel, group) items is ~680 MB requested
// from L1 and L2 (the K/V clip, 9.4 MB, stays in L2); offsets that reuse L1
// (a smooth flow) cut the time by only a quarter.
//
// Design. An item is one (query pixel, group). A thread holds VEC channels
// of the group (8 where cg and the pointers allow it), so each corner of k
// and of v is one 16-byte load; TPI = cg / VEC threads make up an item (3
// at cg 24, 4 at cg 32) and their partial dots sum in a fixed order over
// TPI shuffles, the same on every thread, so every thread of the item keeps
// the same online softmax (running max, sum) beside its own channels' f32
// accumulator. A block of eight warps walks a tile of TH x 8 query pixels
// of one (query frame, group), so neighbouring pixels, whose taps hit the
// same K/V rows, are read while the rows are in the SM's L1; threads past a
// warp's last item idle (2 of 32 at cg 24), and an item past the map's
// edge computes a clamped pixel and stores nothing. The item's offsets are
// read TPI taps at a time, one (y, x) pair a thread from the contiguous run
// of its taps, and handed round by shuffles; at RVRT's geometry (3x3 taps,
// cg 24 or 32) a clip slot's nine pairs are read at once and the tap loop
// is unrolled with its tap offsets and the item's thread count as
// constants. Every other geometry takes one generic walk of its vector
// width: six instances in all. A corner outside the frame reads a clamped
// pixel at weight 0, as the plain version does, so the loads need no
// predicate; a corner's k and v addresses are one wide multiply-add each
// from the frame's bases. The TPU kernel's 2-hot matmuls, hat weights,
// MXU_MAX_HW and lane padding are TPU gather workarounds with no
// counterpart here; its samples are summed in the input type
// (preferred_element_type=dt), these in f32.
//
// Layouts: q, out [Bq][H][W][C] bf16 (Bq = B * frames); k, v
// [B][clip][H][W][C] bf16; off [Bq][clip][H][W][DG][K][2] f32.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileW = 8;       // query pixels a tile row

// ops/kernels/gda_block.py gda_plan mirrors this (chip_smoke.py phase 1
// holds the two equal).
struct GdaPlan {
  int vec;      // channels a thread: one load of 2 * vec bytes a corner
  int tpi;      // threads that hold an item's channels: cg / vec
  int ipw;      // items a warp: 32 / tpi
  int th, tw;   // a block's tile of query pixels: kWarps * ipw of them
  int tiles_y, tiles_x;
};

int make_plan(int C, int DG, int K, int clip, int H, int W, int align, GdaPlan* p) {
  if (DG < 1 || C % DG || C / DG > 32 || K < 1 || clip < 1 || clip * K > 32 ||
      H < 1 || W < 1 || (long long)H * W >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int cg = C / DG;
  int vec = 8;
  while (vec > 1 && (cg % vec || align % (2 * vec))) vec >>= 1;
  p->vec = vec;
  p->tpi = cg / vec;
  p->ipw = 32 / p->tpi;
  p->tw = kTileW;
  p->th = kWarps * p->ipw / kTileW;
  p->tiles_y = (H + p->th - 1) / p->th;
  p->tiles_x = (W + p->tw - 1) / p->tw;
  return 0;
}

struct GdaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* off;
  bf16* out;
  int Bq, frames, clip, H, W, C, DG, kh, kw;
  float scale;
};

template <int V> struct Lanes;
template <> struct Lanes<8> { typedef uint4 T; };
template <> struct Lanes<4> { typedef uint2 T; };
template <> struct Lanes<2> { typedef unsigned T; };
template <> struct Lanes<1> { typedef unsigned short T; };

template <int V>
__device__ __forceinline__ typename Lanes<V>::T load_vec(const bf16* p) {
  return __ldg(reinterpret_cast<const typename Lanes<V>::T*>(p));
}

// f[i] += w * (bf16 element i of r), in f32
template <int V>
__device__ __forceinline__ void add_scaled(const typename Lanes<V>::T& r, float w, float* f) {
  if constexpr (V == 1) {
    f[0] = fmaf(w, __uint_as_float((unsigned)r << 16), f[0]);
  } else {
    const unsigned* u = reinterpret_cast<const unsigned*>(&r);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      f[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), f[2 * i]);
      f[2 * i + 1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u), f[2 * i + 1]);
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float* f) {
  if constexpr (V == 1) {
    *p = __float2bfloat16(f[0]);
  } else {
    typename Lanes<V>::T r;
    unsigned* u = reinterpret_cast<unsigned*>(&r);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const bf162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<typename Lanes<V>::T*>(p) = r;
  }
}

// The item's TPI partial dots, summed in one order on every thread of the
// item whose first lane is `first`: a butterfly for a power of two, else in
// thread order. TPI 0: the count read from the plan (the generic walk).
template <int TPI>
__device__ __forceinline__ float item_sum(float v, int tpi, int first, unsigned mask) {
  if constexpr (TPI == 4) {
#pragma unroll
    for (int o = 1; o < TPI; o <<= 1) v += __shfl_xor_sync(mask, v, o);
    return v;
  } else if constexpr (TPI == 3) {
    const float a = __shfl_sync(mask, v, first), b = __shfl_sync(mask, v, first + 1);
    return (a + b) + __shfl_sync(mask, v, first + 2);
  } else {
    if ((tpi & (tpi - 1)) == 0) {
      for (int o = 1; o < tpi; o <<= 1) v += __shfl_xor_sync(mask, v, o);
      return v;
    }
    float r = 0.f;
    for (int q = 0; q < tpi; ++q) r += __shfl_sync(mask, v, first + q);
    return r;
  }
}

// One tap of an item: the bilinear samples of k and v at (fy, fx) in the KV
// frame at kf and vf (the item's channels of pixel 0), the score against
// qv, and the online
// softmax update of (m_run, l_run, acc). A corner outside the frame reads a
// clamped pixel at weight 0, as the plain version does, so the loads need
// no predicate.
template <int V, int TPI>
__device__ __forceinline__ void gda_tap(float fy, float fx, const char* kf, const char* vf,
                                        int H, int W, int C, const float* qv, int tpi,
                                        int first, unsigned mask, float& m_run,
                                        float& l_run, float* acc) {
  typedef typename Lanes<V>::T Vec;
  const float y0f = floorf(fy), x0f = floorf(fx);
  const int y0 = (int)y0f, x0 = (int)x0f;
  const float ly = fy - y0f, lx = fx - x0f;
  const float wy[2] = {(unsigned)y0 < (unsigned)H ? 1.f - ly : 0.f,
                       (unsigned)(y0 + 1) < (unsigned)H ? ly : 0.f};
  const float wx[2] = {(unsigned)x0 < (unsigned)W ? 1.f - lx : 0.f,
                       (unsigned)(x0 + 1) < (unsigned)W ? lx : 0.f};
  const int yc[2] = {min(max(y0, 0), H - 1), min(max(y0 + 1, 0), H - 1)};
  const int xc[2] = {min(max(x0, 0), W - 1), min(max(x0 + 1, 0), W - 1)};
  Vec kr[4], vr[4];
  float wt[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned px = yc[c >> 1] * W + xc[c & 1];  // byte offsets: one wide IMAD each
    kr[c] = load_vec<V>(reinterpret_cast<const bf16*>(kf + (size_t)px * (2 * C)));
    vr[c] = load_vec<V>(reinterpret_cast<const bf16*>(vf + (size_t)px * (2 * C)));
    wt[c] = wy[c >> 1] * wx[c & 1];
  }
  float ks[V];
#pragma unroll
  for (int c = 0; c < V; ++c) ks[c] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) add_scaled<V>(kr[c], wt[c], ks);
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < V; ++c) dot = fmaf(qv[c], ks[c], dot);
  const float score = item_sum<TPI>(dot, tpi, first, mask);
  // acc = acc * corr + pr * v_s, the sample's weights scaled by pr
  const float m_new = fmaxf(m_run, score);
  const float corr = __expf(m_run - m_new), pr = __expf(score - m_new);
  l_run = l_run * corr + pr;
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] *= corr;
#pragma unroll
  for (int c = 0; c < 4; ++c) add_scaled<V>(vr[c], pr * wt[c], acc);
  m_run = m_new;
}

__device__ __forceinline__ float2 load_off(const float* o, bool off8) {
  return off8 ? __ldg(reinterpret_cast<const float2*>(o)) : make_float2(__ldg(o), __ldg(o + 1));
}

// K3: the taps are 3x3 (RVRT's, TPI 3 or 4), walked with compile-time tap
// offsets, and a clip slot's nine (y, x) pairs are read at the slot's start.
template <int V, int TPI, bool K3>
__global__ void __launch_bounds__(kThreads, 3) gda_kernel(GdaArgs a, GdaPlan p) {
  const int tpi = TPI ? TPI : p.tpi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / tpi;
  if (slot >= p.ipw) return;                          // past the warp's last item
  const int used = p.ipw * tpi;
  const unsigned mask = used == 32 ? 0xffffffffu : (1u << used) - 1u;
  const int t = lane - slot * tpi, first = lane - t;

  // block -> (bq, g, tile); item -> pixel of the tile
  const int tiles = p.tiles_y * p.tiles_x;
  const int tile = (int)(blockIdx.x % tiles);
  const int bg = (int)(blockIdx.x / tiles);
  const int g = bg % a.DG, bq = bg / a.DG;
  const int i = warp * p.ipw + slot;
  const int y_ = tile / p.tiles_x * p.th + i / p.tw;
  const int x_ = tile % p.tiles_x * p.tw + i % p.tw;
  const bool valid = y_ < a.H && x_ < a.W;
  const int y = min(y_, a.H - 1), x = min(x_, a.W - 1);

  const int H = a.H, W = a.W, C = a.C, G = a.DG, clip = a.clip;
  const int cg = C / G, K = a.kh * a.kw;
  const int bk = bq / a.frames, j = (bq - bk * a.frames) % clip;
  const size_t pix = ((size_t)bq * H + y) * W + x;

  float qv[V];
#pragma unroll
  for (int c = 0; c < V; ++c) qv[c] = 0.f;
  add_scaled<V>(load_vec<V>(a.q + pix * C + g * cg + t * V), a.scale, qv);

  // the offsets: this thread reads the (y, x) pair of the item's taps t,
  // t + tpi, ... (tap (n, k) at op + n * n_stride + 2k), the others get
  // them by shuffles
  const size_t n_stride = (size_t)H * W * G * K * 2;
  const float* op = a.off + (((size_t)bq * clip * H + y) * W + x) * G * K * 2 + (size_t)g * K * 2;
  const bool off8 = (reinterpret_cast<size_t>(a.off) & 7) == 0;

  const size_t frame_el = (size_t)H * W * C;
  const size_t kv0 = (size_t)bk * clip * frame_el + g * cg + t * V;
  const char* kb = reinterpret_cast<const char*>(a.k);
  const char* vb = reinterpret_cast<const char*>(a.v);

  float m_run = -1e30f, l_run = 0.f, acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;

  if constexpr (K3) {
    constexpr int NO = (9 + TPI - 1) / TPI;           // pairs a thread reads a slot
    for (int n = 0; n < clip; ++n) {
      float2 mo[NO];
#pragma unroll
      for (int r = 0; r < NO; ++r)
        mo[r] = t + r * TPI < 9 ? load_off(op + n * n_stride + 2 * (t + r * TPI), off8)
                                : make_float2(0.f, 0.f);
      const size_t fo = 2 * (kv0 + (size_t)(n + j < clip ? n + j : n + j - clip) * frame_el);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float oy = __shfl_sync(mask, mo[k / TPI].x, first + k % TPI);
        const float ox = __shfl_sync(mask, mo[k / TPI].y, first + k % TPI);
        gda_tap<V, TPI>((float)(y + k / 3 - 1) + oy, (float)(x + k % 3 - 1) + ox, kb + fo,
                        vb + fo, H, W, C, qv, tpi, first, mask, m_run, l_run, acc);
      }
    }
  } else {
    const int S = clip * K;
    int my_n = t / K, my_k = t - my_n * K;
    float2 mine = make_float2(0.f, 0.f);
    int n = 0, ky = 0, kx = 0, rem = 0;               // tap s = (n, ky * kw + kx)
    size_t fo = 2 * (kv0 + (size_t)j * frame_el);      // KV frame (n + j) % clip
    for (int s = 0; s < S; ++s) {
      if (rem == 0) {                                 // the next tpi taps' offsets
        if (s + t < S) mine = load_off(op + my_n * n_stride + 2 * my_k, off8);
        for (my_k += tpi; my_k >= K; my_k -= K) ++my_n;
      }
      const float oy = __shfl_sync(mask, mine.x, first + rem);
      const float ox = __shfl_sync(mask, mine.y, first + rem);
      if (++rem == tpi) rem = 0;
      gda_tap<V, TPI>((float)(y + ky - a.kh / 2) + oy, (float)(x + kx - a.kw / 2) + ox,
                      kb + fo, vb + fo, H, W, C, qv, tpi, first, mask, m_run, l_run, acc);
      if (++kx == a.kw) {
        kx = 0;
        if (++ky == a.kh) {
          ky = 0;
          ++n;
          fo = 2 * (kv0 + (size_t)(n + j < clip ? n + j : n + j - clip) * frame_el);
        }
      }
    }
  }
  if (valid) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] *= inv;
    store_vec<V>(a.out + pix * C + g * cg + t * V, acc);
  }
}

int ptr_align(const void* const* ptrs, int n) {
  unsigned long long bits = 16;
  for (int i = 0; i < n; ++i) bits |= reinterpret_cast<unsigned long long>(ptrs[i]);
  return (int)(bits & (~bits + 1));                   // lowest set bit, at most 16
}

}  // namespace

// The plan at C channels, DG groups, kh*kw = K taps a clip slot, clip
// slots, an H x W map and pointers aligned to `align` bytes: dst (i32[7]) =
// vec, tpi, ipw, th, tw, tiles_y, tiles_x. Returns cudaErrorInvalidValue for
// a geometry the kernel does not take.
extern "C" int kair_gda_plan(int C, int DG, int K, int clip, int H, int W, int align,
                             int* dst) {
  GdaPlan p;
  const int err = make_plan(C, DG, K, clip, H, W, align, &p);
  if (err) return err;
  const int v[7] = {p.vec, p.tpi, p.ipw, p.th, p.tw, p.tiles_y, p.tiles_x};
  for (int i = 0; i < 7; ++i) dst[i] = v[i];
  return 0;
}

// q [Bq][H][W][C] bf16, k, v [Bq/frames][clip][H][W][C] bf16,
// off [Bq][clip][H][W][DG][kh*kw][2] f32, out [Bq][H][W][C] bf16;
// Bq, frames, clip, H, W, C, DG, kh, kw, stream. Query b*frames + j pairs KV
// slot n with frame (n + j) % clip of KV batch b; heads == DG.
extern "C" int kair_gda(const void* q, const void* k, const void* v, const void* off,
                        void* out, int Bq, int frames, int clip, int H, int W, int C,
                        int DG, int kh, int kw, void* stream) {
  if (frames < 1 || Bq < 1 || Bq % frames || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  GdaPlan p;
  const int err = make_plan(C, DG, kh * kw, clip, H, W, ptr_align(ptrs, 4), &p);
  if (err) return err;
  const long long blocks = (long long)Bq * DG * p.tiles_y * p.tiles_x;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  GdaArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.off = static_cast<const float*>(off);
  a.out = static_cast<bf16*>(out);
  a.Bq = Bq; a.frames = frames; a.clip = clip; a.H = H; a.W = W; a.C = C;
  a.DG = DG; a.kh = kh; a.kw = kw;
  a.scale = 1.f / sqrtf((float)(C / DG));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  // compile-time thread counts only for RVRT's traffic (3x3 taps at cg 24
  // and 32); every other geometry takes the generic walk of its vector
  const bool k3 = kh == 3 && kw == 3 && p.vec == 8;
  if (k3 && p.tpi == 3) {
    gda_kernel<8, 3, true><<<grid, kThreads, 0, st>>>(a, p);
  } else if (k3 && p.tpi == 4) {
    gda_kernel<8, 4, true><<<grid, kThreads, 0, st>>>(a, p);
  } else if (p.vec == 8) {
    gda_kernel<8, 0, false><<<grid, kThreads, 0, st>>>(a, p);
  } else if (p.vec == 4) {
    gda_kernel<4, 0, false><<<grid, kThreads, 0, st>>>(a, p);
  } else if (p.vec == 2) {
    gda_kernel<2, 0, false><<<grid, kThreads, 0, st>>>(a, p);
  } else {
    gda_kernel<1, 0, false><<<grid, kThreads, 0, st>>>(a, p);
  }
  return (int)cudaGetLastError();
}
