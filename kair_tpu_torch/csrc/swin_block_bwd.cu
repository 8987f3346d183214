// Backward of the fused Swin block on 8x8 windows, training, bf16 (sm_90a).
//
// Replaces the TPU kernel kair_tpu/ops/pallas/swin_block.py ::
// _fused_2d_bwd_pallas (_kernel_2d_bwd). Given the block input x (already
// rolled: phase 0) and dy, it recomputes the block forward (LN1, qkv,
// softmax with the row max subtracted, rel-pos bias and optional 0/-100
// mask, PV, proj, residual, LN2, fc1, exact GELU) and chains back to
//   dx (B,H,W,C) bf16, and f32 grads of qkv W/b, proj W/b, fc1 W/b,
//   fc2 W/b, norm1/norm2 weight and bias, and the (NH,64,64) score bias
//   summed over all windows.
//
// Bound on the H100: at SwinIR-M width one call does about 1.56 MFLOP per
// token (forward recompute without fc2, then two products per weight matrix
// and four attention products) against 1,080 bytes of x, dy and dx, so it
// is bound by tensor-core operations (0.117 ms at 989 TFLOP/s for 73,728
// tokens). What the design does about it:
//
// * The TPU kernel walks its grid in order and accumulates every weight grad
//   in one resident output block. Hopper's blocks run in no order, so the
//   work is split in two passes. Pass 1 (swin_block_bwd_kernel) gives each
//   8x8 window one thread block of 16 warps, keeps the whole window's chain
//   in shared memory (218 KB at C=180) and writes dx plus the per-token
//   operands of the four weight products to device memory: LN1 out with
//   dqkv, attention out with dx1, LN2 out with dpre, GELU out with dy, each
//   row with a 1 in a padding column, so that the same product also yields
//   the bias grad. Pass 2 (swin_wgrad_kernel) computes the products
//   tokens^T x tokens on the tensor cores with f32 accumulation, split over
//   token chunks into per-chunk partials; sum_rows_kernel adds the partials
//   in a fixed order. No atomics: the result is the same on every run.
//   The LayerNorm parameter grads and the score-bias grad are per-window
//   partial sums, added by sum_rows_kernel in window order.
// * Shared memory: the attention backward goes head by head and recomputes
//   that head's scores, so only one head's 64x64 probabilities are resident;
//   q/k/v go to device memory after the forward and come back for the
//   attention backward, which frees their space for the MLP backward.
// * All matrix products are WMMA bf16 with f32 accumulation, as the forward.
//   This is the simple first version: weights and pass-2 operands are read
//   from L2 by every warp, with no TMA pipeline.
//
// Layouts (host side: ops/kernels/swin_block.py, pack_swin_block with
// folded=False and swin_block_2d_bwd):
//   wqkv [CP][NH*96] bf16 per head [q|k|v] 32 columns each, NOT scaled and
//   without the LN1 affine; wp [NH*32][CP]; w1 [CP][HP] without the LN2
//   affine; w2 [HP][CP]; biases f32; ln [4][C] f32 (norm1 w, b, norm2 w, b).
//   Stored operands, row = pixel index b*H*W + r*W + c:
//   h1, ao, h2 [T][K1] (K1 = round16(C+1), ones at column C); g [T][KG]
//   (KG = round16(hidden+1), ones at column hidden); dqkv [T][N3] (N3 =
//   round16(3C), KAIR order [q|k|v] x heads); dx1, dyp [T][CP]; dp [T][HP].
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8, kPadF = 4;
constexpr int kLS = 64 + kPadF;              // 64-wide f32 row stride
constexpr int kLP = 2 * kLS;                 // bf16 view of such a row

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAt;

struct BwdArgs {
  const bf16* x;
  const bf16* dy;
  const bf16* wqkv;
  const float* bqkv;
  const bf16* wp;
  const float* bp;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const float* ln;
  const float* relbias;
  const float* mask;
  bf16* qkv_s;          // [nWin][64][NH*96] q/k/v between forward and backward
  bf16* h1;
  bf16* ao;
  bf16* h2;
  bf16* g;
  bf16* dyp;
  bf16* dp;
  bf16* dx1;
  bf16* dqkv;
  float* part_ln;       // [nWin][4][C]
  float* part_bias;     // [nWin][NH][64][64]
  bf16* dx;
  float scale;
  int B, H, W, C, NH, hidden, HP, K1, KG, N3;
};

// Shared-memory regions (byte offsets), reused as the chain goes on:
//   x   f32 [64][C]  x → x1 → x̂2; later dO bf16 [64][la] + P f32 [64][kLS]; dh
//   f   f32 [64][C]  scores (forward); dh2 → dx1
//   a   bf16 [64][la] h1, attention out, h2, dy, dx1; later dP/dS f32 [64][kLS]
//   big bf16 [64][lq] qkv; GELU' → dpre [64][lh]; qkv again → dqkv
struct BwdSmem {
  int la, lq, lh;
  int x, f, a, big, stage, cb, ln, stats, total;
  __host__ __device__ BwdSmem(int C, int NH, int HP) {
    la = imax(round16(C), NH * 32) + kPad;
    lq = NH * 96 + kPad;
    lh = HP + kPad;
    x = 0;
    f = align128(x + imax(64 * C * 4, align128(64 * la * 2) + 64 * kLS * 4));
    a = align128(f + imax(64 * C * 4, 64 * kLS * 4));
    big = align128(a + imax(64 * la * 2, 64 * kLS * 4));
    stage = align128(big + 64 * imax(lq, lh) * 2);
    cb = align128(stage + kWarps * kStage * 4);   // bqkv | bp | b1 | b2
    ln = cb + (NH * 96 + C + HP + C) * 4;         // norm1 w, b, norm2 w, b
    stats = ln + 4 * C * 4;                       // mu1, inv1, mu2, inv2 [64]
    total = stats + 4 * 64 * 4;
  }
};

// out[64, 16*n_tiles] = A[64, 16*k_tiles] @ Bᵀ for B stored row-major
// [16*n_tiles][ldb] in global memory (a weight read transposed), then epi
// per element. Same warp split as gemm_m64.
template <int NW, class Epi>
__device__ void gemm_m64_bt(const bf16* A, int lda, const bf16* __restrict__ B,
                            int ldb, int k_tiles, int n_tiles, float* stage, Epi& epi) {
  const int warp = threadIdx.x >> 5;
  for (int n = warp; n < n_tiles; n += NW) {
    FragC acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int k = 0; k < k_tiles; ++k) {
      FragBt b;
      wmma::load_matrix_sync(b, B + (size_t)n * 16 * ldb + k * 16, ldb);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        FragA a;
        wmma::load_matrix_sync(a, A + m * 16 * lda + k * 16, lda);
        wmma::mma_sync(acc[m], a, b, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) drain_tile(acc[m], stage, m * 16, n * 16, epi);
  }
}

// LayerNorm with its affine of the 64 rows of xs into bf16 dst[64][ld]
// (columns C..CP-1 zeroed); the row mean and 1/std are kept for the backward.
__device__ void layernorm64_affine(const float* xs, int C, int CP, const float* w,
                                   const float* bb, bf16* dst, int ld, float* mu,
                                   float* inv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < 64; t += kWarps) {
    const float* row = xs + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
    if (lane == 0) {
      mu[t] = mean;
      inv[t] = rstd;
    }
    for (int c = lane; c < CP; c += 32)
      dst[t * ld + c] = __float2bfloat16(c < C ? (row[c] - mean) * rstd * w[c] + bb[c] : 0.f);
  }
}

// Rows of a stored operand for the window's 64 tokens: dst[pixel(t)][col] =
// get(t, col) for col in [0, width); width is even, threads take column pairs.
template <class Get>
__device__ void store_rows(bf16* dst, int width, size_t pix0, int W, Get get) {
  const int half = width >> 1;
  for (int i = threadIdx.x; i < 64 * half; i += kThreads) {
    const int t = i / half, c = 2 * (i - t * half);
    const size_t row = pix0 + (size_t)(t >> 3) * W + (t & 7);
    bf162 v;
    v.x = get(t, c);
    v.y = get(t, c + 1);
    reinterpret_cast<bf162*>(dst + row * width)[c >> 1] = v;
  }
}

// LayerNorm backward for the window. g (f32 [64][C]) is the grad w.r.t. the
// LN output, xhat(t, c) the normalised input, inv[t] its 1/std. Writes the
// column sums of g·x̂ and g (this window's share of the weight and bias
// grads) to part[0..C) and part[C..2C), and hands out(t, c, dinput) the
// grad w.r.t. the LN input, row by row.
template <class Xhat, class Out>
__device__ void layernorm64_bwd(const float* g, int C, const float* w, const float* inv,
                                Xhat xhat, float* part, Out out) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f, sb = 0.f;
    for (int t = 0; t < 64; ++t) {
      const float v = g[t * C + c];
      s += v * xhat(t, c);
      sb += v;
    }
    part[c] = s;
    part[C + c] = sb;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < 64; t += kWarps) {
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dz = g[t * C + c] * w[c];
      m1 += dz;
      m2 += dz * xhat(t, c);
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    for (int c = lane; c < C; c += 32) {
      const float dz = g[t * C + c] * w[c];
      out(t, c, inv[t] * (dz - m1 - xhat(t, c) * m2));
    }
  }
}

__global__ void __launch_bounds__(kThreads) swin_block_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, CP = round16(C), NH = a.NH, HP = a.HP, HID = a.hidden;
  const int H = a.H, W = a.W, QW = NH * 96, HD = C / NH;
  const float scale = a.scale;
  const BwdSmem L(C, NH, HP);
  const int LA = L.la, LQ = L.lq, LH = L.lh;
  float* xs = reinterpret_cast<float*>(smem + L.x);
  bf16* dob = reinterpret_cast<bf16*>(smem + L.x);
  float* Pf = reinterpret_cast<float*>(smem + L.x + align128(64 * LA * 2));
  bf16* Pb = reinterpret_cast<bf16*>(Pf);           // row i at Pb + kLP*i
  float* fs = reinterpret_cast<float*>(smem + L.f);
  bf16* P = reinterpret_cast<bf16*>(fs);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.a);
  float* dPf = reinterpret_cast<float*>(smem + L.a);
  bf16* dSb = reinterpret_cast<bf16*>(dPf);
  bf16* big = reinterpret_cast<bf16*>(smem + L.big);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stage = reinterpret_cast<float*>(smem + L.stage) + warp * kStage;
  float* bqkv = reinterpret_cast<float*>(smem + L.cb);
  float* bp = bqkv + QW;
  float* b1 = bp + C;
  float* b2 = b1 + HP;
  float* lnp = reinterpret_cast<float*>(smem + L.ln);
  float* mu1 = reinterpret_cast<float*>(smem + L.stats);
  float* inv1 = mu1 + 64;
  float* mu2 = mu1 + 128;
  float* inv2 = mu1 + 192;

  const int nwc = W / 8, nwr = H / 8;
  const size_t wid = blockIdx.x;
  int blk = blockIdx.x;
  const int wc = blk % nwc;
  blk /= nwc;
  const int wr = blk % nwr;
  const int b = blk / nwr;
  const int win = wr * nwc + wc;
  const size_t pix0 = ((size_t)b * H + wr * 8) * W + wc * 8;
  auto pix = [&](int t) { return pix0 + (size_t)(t >> 3) * W + (t & 7); };
  const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);

  // ---- parameters and the window --------------------------------------------
  for (int i = tid; i < QW; i += kThreads) bqkv[i] = a.bqkv[i];
  for (int i = tid; i < HP; i += kThreads) b1[i] = a.b1[i];
  for (int i = tid; i < C; i += kThreads) {
    bp[i] = a.bp[i];
    b2[i] = a.b2[i];
  }
  for (int i = tid; i < 4 * C; i += kThreads) lnp[i] = a.ln[i];
  const int C2 = C / 2;
  for (int i = tid; i < 64 * C2; i += kThreads) {
    const int t = i / C2, p = i - t * C2;
    const float2 f = __bfloat1622float2(reinterpret_cast<const bf162*>(a.x + pix(t) * C)[p]);
    xs[t * C + 2 * p] = f.x;
    xs[t * C + 2 * p + 1] = f.y;
  }
  __syncthreads();

  // ---- forward recompute: LN1 → qkv ------------------------------------------
  layernorm64_affine(xs, C, CP, lnp, lnp + C, abuf, LA, mu1, inv1);
  __syncthreads();
  store_rows(a.h1, a.K1, pix0, W, [&](int t, int c) {
    return c < C ? abuf[t * LA + c] : (c == C ? one : zero);
  });
  auto qkv_epi = [&](int r, int c, float v) {
    big[r * LQ + c] = __float2bfloat16(v + bqkv[c]);
  };
  gemm_m64<kWarps>(abuf, LA, a.wqkv, QW, CP / 16, QW / 16, stage, qkv_epi);
  __syncthreads();
  {
    const int vrow = QW / 8;                     // 16-byte vectors per row
    uint4* dst = reinterpret_cast<uint4*>(a.qkv_s + wid * 64 * QW);
    for (int i = tid; i < 64 * vrow; i += kThreads) {
      const int t = i / vrow, v = i - t * vrow;
      dst[i] = reinterpret_cast<const uint4*>(big + t * LQ)[v];
    }
  }

  // ---- attention forward, one head at a time ---------------------------------
  const float* mk_win = a.mask ? a.mask + (size_t)win * 4096 : nullptr;
  constexpr int kRows = 64 / kWarps;
  for (int h = 0; h < NH; ++h) {
    const bf16* Q = big + h * 96;
    const bf16* K = Q + 32;
    const bf16* V = Q + 64;
    {
      const int m = warp >> 2, n = warp & 3;        // 16 tiles, one per warp
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        FragA qa;
        FragBt kb;
        wmma::load_matrix_sync(qa, Q + m * 16 * LQ + k * 16, LQ);
        wmma::load_matrix_sync(kb, K + n * 16 * LQ + k * 16, LQ);
        wmma::mma_sync(acc, qa, kb, acc);
      }
      wmma::store_matrix_sync(fs + m * 16 * kLS + n * 16, acc, kLS, wmma::mem_row_major);
    }
    __syncthreads();
    const float* bias = a.relbias + h * 4096;
    for (int j = 0; j < kRows; ++j) {
      const int i = warp + j * kWarps;
      float s0 = fs[i * kLS + lane] * scale + bias[i * 64 + lane];
      float s1 = fs[i * kLS + lane + 32] * scale + bias[i * 64 + lane + 32];
      if (mk_win) {
        s0 += mk_win[i * 64 + lane];
        s1 += mk_win[i * 64 + lane + 32];
      }
      const float mx = warp_max(fmaxf(s0, s1));
      const float e0 = __expf(s0 - mx), e1 = __expf(s1 - mx);
      const float inv = 1.f / warp_sum(e0 + e1);
      __syncwarp();   // the row's f32 scores are read before their bf16 overwrite
      P[i * kLP + lane] = __float2bfloat16(e0 * inv);
      P[i * kLP + lane + 32] = __float2bfloat16(e1 * inv);
    }
    __syncthreads();
    auto pv_epi = [&](int r, int c, float v) { abuf[r * LA + c] = __float2bfloat16(v); };
    for (int tile = warp; tile < 8; tile += kWarps) {
      const int m = tile >> 1, n = tile & 1;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        FragA pa;
        FragB vb;
        wmma::load_matrix_sync(pa, P + m * 16 * kLP + k * 16, kLP);
        wmma::load_matrix_sync(vb, V + k * 16 * LQ + n * 16, LQ);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      drain_tile(acc, stage, m * 16, h * 32 + n * 16, pv_epi);
    }
    __syncthreads();
  }

  // ---- proj + residual 1 → x1; LN2 → fc1 --------------------------------------
  store_rows(a.ao, a.K1, pix0, W, [&](int t, int c) {
    return c < C ? abuf[t * LA + (c / HD) * 32 + c % HD] : (c == C ? one : zero);
  });
  auto proj_epi = [&](int r, int c, float v) {
    if (c < C) xs[r * C + c] += v + bp[c];
  };
  gemm_m64<kWarps>(abuf, LA, a.wp, CP, NH * 2, CP / 16, stage, proj_epi);
  __syncthreads();
  layernorm64_affine(xs, C, CP, lnp + 2 * C, lnp + 3 * C, abuf, LA, mu2, inv2);
  __syncthreads();
  store_rows(a.h2, a.K1, pix0, W, [&](int t, int c) {
    return c < C ? abuf[t * LA + c] : (c == C ? one : zero);
  });
  // GELU(pre) goes out as an operand, GELU'(pre) stays in big for dpre
  auto fc1_epi = [&](int r, int c, float v) {
    const float u = v + b1[c];
    const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
    const float pdf = 0.3989422804014327f * __expf(-0.5f * u * u);
    big[r * LH + c] = __float2bfloat16(cdf + u * pdf);
    a.g[pix(r) * a.KG + c] = c < HID ? __float2bfloat16(u * cdf) : (c == HID ? one : zero);
  };
  gemm_m64<kWarps>(abuf, LA, a.w1, HP, CP / 16, HP / 16, stage, fc1_epi);
  for (int i = tid; i < 64 * (a.KG - HP); i += kThreads) {   // KG > HP when 16 | hidden
    const int t = i / (a.KG - HP), c = HP + i % (a.KG - HP);
    a.g[pix(t) * a.KG + c] = c == HID ? one : zero;
  }
  __syncthreads();

  // ---- backward: y = x1 + fc2(GELU(fc1(LN2(x1)))) --------------------------------
  for (int i = tid; i < 32 * CP; i += kThreads) {           // dy → abuf, pads 0
    const int t = i / (CP / 2), c = 2 * (i - t * (CP / 2));
    bf162 v;
    v.x = v.y = zero;
    if (c < C) v = reinterpret_cast<const bf162*>(a.dy + pix(t) * C)[c >> 1];
    reinterpret_cast<bf162*>(abuf + t * LA)[c >> 1] = v;
  }
  for (int i = tid; i < 64 * C; i += kThreads) {             // x1 → x̂2
    const int t = i / C;
    xs[i] = (xs[i] - mu2[t]) * inv2[t];
  }
  __syncthreads();
  store_rows(a.dyp, CP, pix0, W, [&](int t, int c) { return abuf[t * LA + c]; });
  auto dhid_epi = [&](int r, int c, float v) {
    const bf16 d = __float2bfloat16(c < HID ? v * __bfloat162float(big[r * LH + c]) : 0.f);
    big[r * LH + c] = d;
    a.dp[pix(r) * HP + c] = d;
  };
  gemm_m64_bt<kWarps>(abuf, LA, a.w2, CP, CP / 16, HP / 16, stage, dhid_epi);
  __syncthreads();
  auto dh2_epi = [&](int r, int c, float v) {
    if (c < C) fs[r * C + c] = v;
  };
  gemm_m64_bt<kWarps>(big, LH, a.w1, HP, HP / 16, CP / 16, stage, dh2_epi);
  __syncthreads();
  // dx1 = dy + LN2ᵀ(dh2), in place in fs
  layernorm64_bwd(fs, C, lnp + 2 * C, inv2,
                  [&](int t, int c) { return xs[t * C + c]; },
                  a.part_ln + (wid * 4 + 2) * C,
                  [&](int t, int c, float d) {
                    fs[t * C + c] = __bfloat162float(abuf[t * LA + c]) + d;
                  });
  __syncthreads();
  for (int i = tid; i < 64 * CP; i += kThreads) {
    const int t = i / CP, c = i - t * CP;
    abuf[t * LA + c] = __float2bfloat16(c < C ? fs[t * C + c] : 0.f);
  }
  __syncthreads();

  // ---- x1 = x + proj(attention) + bp -------------------------------------------
  store_rows(a.dx1, CP, pix0, W, [&](int t, int c) { return abuf[t * LA + c]; });
  auto dacc_epi = [&](int r, int c, float v) { dob[r * LA + c] = __float2bfloat16(v); };
  gemm_m64_bt<kWarps>(abuf, LA, a.wp, CP, CP / 16, NH * 2, stage, dacc_epi);
  {
    const int vrow = QW / 8;
    const uint4* src = reinterpret_cast<const uint4*>(a.qkv_s + wid * 64 * QW);
    for (int i = tid; i < 64 * vrow; i += kThreads) {
      const int t = i / vrow, v = i - t * vrow;
      reinterpret_cast<uint4*>(big + t * LQ)[v] = src[i];
    }
  }
  __syncthreads();

  // ---- attention backward, one head at a time; dq/dk/dv replace q/k/v ----------
  for (int h = 0; h < NH; ++h) {
    bf16* Q = big + h * 96;
    bf16* K = Q + 32;
    bf16* V = Q + 64;
    const bf16* dO = dob + h * 32;
    {
      const int m = warp >> 2, n = warp & 3;
      FragC s, d;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(d, 0.f);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        FragA qa, oa;
        FragBt kb, vb;
        wmma::load_matrix_sync(qa, Q + m * 16 * LQ + k * 16, LQ);
        wmma::load_matrix_sync(kb, K + n * 16 * LQ + k * 16, LQ);
        wmma::mma_sync(s, qa, kb, s);                      // q kᵀ
        wmma::load_matrix_sync(oa, dO + m * 16 * LA + k * 16, LA);
        wmma::load_matrix_sync(vb, V + n * 16 * LQ + k * 16, LQ);
        wmma::mma_sync(d, oa, vb, d);                      // dP = dO vᵀ
      }
      wmma::store_matrix_sync(Pf + m * 16 * kLS + n * 16, s, kLS, wmma::mem_row_major);
      wmma::store_matrix_sync(dPf + m * 16 * kLS + n * 16, d, kLS, wmma::mem_row_major);
    }
    __syncthreads();
    // softmax again, then dS = P ∘ (dP − rowsum(dP ∘ P)); bf16 P and dS are
    // written over the first half of their own f32 rows
    const float* bias = a.relbias + h * 4096;
    float* pb = a.part_bias + (wid * NH + h) * 4096;
    for (int j = 0; j < kRows; ++j) {
      const int i = warp + j * kWarps;
      float s0 = Pf[i * kLS + lane] * scale + bias[i * 64 + lane];
      float s1 = Pf[i * kLS + lane + 32] * scale + bias[i * 64 + lane + 32];
      if (mk_win) {
        s0 += mk_win[i * 64 + lane];
        s1 += mk_win[i * 64 + lane + 32];
      }
      const float mx = warp_max(fmaxf(s0, s1));
      const float e0 = __expf(s0 - mx), e1 = __expf(s1 - mx);
      const float inv = 1.f / warp_sum(e0 + e1);
      const float p0 = e0 * inv, p1 = e1 * inv;
      const float dp0 = dPf[i * kLS + lane], dp1 = dPf[i * kLS + lane + 32];
      const float rs = warp_sum(dp0 * p0 + dp1 * p1);
      const float ds0 = p0 * (dp0 - rs), ds1 = p1 * (dp1 - rs);
      pb[i * 64 + lane] = ds0;
      pb[i * 64 + lane + 32] = ds1;
      __syncwarp();
      Pb[i * kLP + lane] = __float2bfloat16(p0);
      Pb[i * kLP + lane + 32] = __float2bfloat16(p1);
      dSb[i * kLP + lane] = __float2bfloat16(ds0);
      dSb[i * kLP + lane + 32] = __float2bfloat16(ds1);
    }
    __syncthreads();
    // 24 tiles of 16x16: dq = scale·dS k (0-7), dk = scale·dSᵀ q (8-15),
    // dv = Pᵀ dO (16-23); results wait in registers until every warp has
    // read this head's q/k/v
    FragC acc[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int tile = warp + s * kWarps;
      if (tile >= 24) continue;
      const int kind = tile >> 3, m = (tile & 7) >> 1, n = tile & 1;
      wmma::fill_fragment(acc[s], 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        FragB bb;
        if (kind == 0) {
          FragA fa;
          wmma::load_matrix_sync(fa, dSb + m * 16 * kLP + k * 16, kLP);
          wmma::load_matrix_sync(bb, K + k * 16 * LQ + n * 16, LQ);
          wmma::mma_sync(acc[s], fa, bb, acc[s]);
        } else {
          FragAt fa;
          wmma::load_matrix_sync(fa, (kind == 1 ? dSb : Pb) + k * 16 * kLP + m * 16, kLP);
          if (kind == 1)
            wmma::load_matrix_sync(bb, Q + k * 16 * LQ + n * 16, LQ);
          else
            wmma::load_matrix_sync(bb, dO + k * 16 * LA + n * 16, LA);
          wmma::mma_sync(acc[s], fa, bb, acc[s]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int tile = warp + s * kWarps;
      if (tile >= 24) continue;
      const int kind = tile >> 3, m = (tile & 7) >> 1, n = tile & 1;
      const float f = kind < 2 ? scale : 1.f;
      bf16* dst = big + h * 96 + kind * 32;
      auto epi = [&](int r, int c, float v) { dst[r * LQ + c] = __float2bfloat16(v * f); };
      drain_tile(acc[s], stage, m * 16, n * 16, epi);
    }
    __syncthreads();
  }

  // ---- qkv = LN1(x) Wqkv + b; dx = dx1 + LN1ᵀ(dqkv Wqkvᵀ) -----------------------
  store_rows(a.dqkv, a.N3, pix0, W, [&](int t, int c) {
    if (c >= 3 * C) return zero;
    const int j = c / C, r = c - j * C, hh = r / HD;
    return big[t * LQ + hh * 96 + j * 32 + (r - hh * HD)];
  });
  auto dh_epi = [&](int r, int c, float v) {
    if (c < C) xs[r * C + c] = v;
  };
  gemm_m64_bt<kWarps>(big, LQ, a.wqkv, QW, QW / 16, CP / 16, stage, dh_epi);
  __syncthreads();
  layernorm64_bwd(xs, C, lnp, inv1,
                  [&](int t, int c) {
                    return (__bfloat162float(a.x[pix(t) * C + c]) - mu1[t]) * inv1[t];
                  },
                  a.part_ln + wid * 4 * C,
                  [&](int t, int c, float d) {
                    a.dx[pix(t) * C + c] = __float2bfloat16(fs[t * C + c] + d);
                  });
}

// Pass 2: D = Aᵀ B over a chunk of token rows, for the four weight products.
// A [T][ka], B [T][nb] bf16 (ka, nb multiples of 16); one block of 4 warps
// per 64x64 tile of D, each warp 32x32; partial sums to part[chunk][...].
struct WgradProduct {
  const bf16* A;
  const bf16* B;
  int ka, nb;
  long long off;        // offset of this product's D in a partial
};

struct WgradArgs {
  WgradProduct p[4];
  int tile_start[5];
  int T, chunk;
  long long total;      // floats per partial
  float* part;
};

__global__ void __launch_bounds__(128) swin_wgrad_kernel(WgradArgs a) {
  int q = 0;
  while (q < 3 && (int)blockIdx.x >= a.tile_start[q + 1]) ++q;
  const WgradProduct p = a.p[q];
  const int local = blockIdx.x - a.tile_start[q];
  const int ntn = (p.nb + 63) / 64;
  const int warp = threadIdx.x >> 5;
  const int m0 = (local / ntn) * 64 + (warp >> 1) * 32;
  const int n0 = (local % ntn) * 64 + (warp & 1) * 32;
  const bool mv[2] = {m0 < p.ka, m0 + 16 < p.ka};
  const bool nv[2] = {n0 < p.nb, n0 + 16 < p.nb};
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int t0 = blockIdx.y * a.chunk;
  const int t1 = min(a.T, t0 + a.chunk);
  for (int t = t0; t < t1; t += 16) {
    FragAt fa[2];
    FragB fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (mv[i]) wmma::load_matrix_sync(fa[i], p.A + (size_t)t * p.ka + m0 + 16 * i, p.ka);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (nv[j]) wmma::load_matrix_sync(fb[j], p.B + (size_t)t * p.nb + n0 + 16 * j, p.nb);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (mv[i] && nv[j]) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
  float* out = a.part + (size_t)blockIdx.y * a.total + p.off;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (mv[i] && nv[j])
        wmma::store_matrix_sync(out + (size_t)(m0 + 16 * i) * p.nb + n0 + 16 * j,
                                acc[i][j], p.nb, wmma::mem_row_major);
}

// dst[j] = Σ_r src[r][j], r in order (the same sum on every run).
__global__ void sum_rows_kernel(const float* __restrict__ src, int rows,
                                long long cols, float* __restrict__ dst) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) s += src[(size_t)r * cols + j];
  dst[j] = s;
}

int sum_rows(const float* src, int rows, long long cols, float* dst, cudaStream_t st) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((cols + threads - 1) / threads);
  sum_rows_kernel<<<blocks, threads, 0, st>>>(src, rows, cols, dst);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kair_swin_block_bwd_shared_bytes(int C, int NH, int HP) {
  return BwdSmem(C, NH, HP).total;
}

// One call = pass 1, pass 2 and the three ordered sums, on `stream`.
// dw receives the four products D back to back: [K1][N3] (qkv), [K1][CP]
// (proj), [K1][HP] (fc1), [KG][CP] (fc2); dln [4][C]; dbias [NH][64][64].
extern "C" int kair_swin_block_2d_bwd(
    const void* x, const void* dy, const void* wqkv, const void* bqkv,
    const void* wp, const void* bp, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* ln, const void* relbias,
    const void* mask, void* qkv_s, void* h1, void* ao, void* h2, void* g,
    void* dyp, void* dp, void* dx1, void* dqkv, void* part_ln,
    void* part_bias, void* part_w, void* dx, void* dw, void* dln, void* dbias,
    int B, int H, int W, int C, int NH, int hidden, int HP, int K1, int KG,
    int N3, int splits, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = BwdSmem(C, NH, HP).total;
  cudaError_t e = cudaFuncSetAttribute(
      swin_block_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  BwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.dy = static_cast<const bf16*>(dy);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.ln = static_cast<const float*>(ln);
  a.relbias = static_cast<const float*>(relbias);
  a.mask = static_cast<const float*>(mask);
  a.qkv_s = static_cast<bf16*>(qkv_s);
  a.h1 = static_cast<bf16*>(h1);
  a.ao = static_cast<bf16*>(ao);
  a.h2 = static_cast<bf16*>(h2);
  a.g = static_cast<bf16*>(g);
  a.dyp = static_cast<bf16*>(dyp);
  a.dp = static_cast<bf16*>(dp);
  a.dx1 = static_cast<bf16*>(dx1);
  a.dqkv = static_cast<bf16*>(dqkv);
  a.part_ln = static_cast<float*>(part_ln);
  a.part_bias = static_cast<float*>(part_bias);
  a.dx = static_cast<bf16*>(dx);
  a.scale = scale;
  a.B = B; a.H = H; a.W = W; a.C = C; a.NH = NH; a.hidden = hidden;
  a.HP = HP; a.K1 = K1; a.KG = KG; a.N3 = N3;
  const int n_win = B * (H / 8) * (W / 8);
  swin_block_bwd_kernel<<<n_win, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int CP = round16(C);
  WgradArgs w;
  const bf16* As[4] = {a.h1, a.ao, a.h2, a.g};
  const bf16* Bs[4] = {a.dqkv, a.dx1, a.dp, a.dyp};
  const int kas[4] = {K1, K1, K1, KG};
  const int nbs[4] = {N3, CP, HP, CP};
  long long off = 0;
  w.tile_start[0] = 0;
  for (int i = 0; i < 4; ++i) {
    w.p[i].A = As[i];
    w.p[i].B = Bs[i];
    w.p[i].ka = kas[i];
    w.p[i].nb = nbs[i];
    w.p[i].off = off;
    off += (long long)kas[i] * nbs[i];
    w.tile_start[i + 1] = w.tile_start[i] + ((kas[i] + 63) / 64) * ((nbs[i] + 63) / 64);
  }
  const int T = B * H * W;
  w.T = T;
  w.chunk = ((T + splits - 1) / splits + 15) / 16 * 16;
  w.total = off;
  w.part = static_cast<float*>(part_w);
  swin_wgrad_kernel<<<dim3(w.tile_start[4], splits), 128, 0, st>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int err = sum_rows(w.part, splits, off, static_cast<float*>(dw), st);
  if (err) return err;
  err = sum_rows(a.part_ln, n_win, 4LL * C, static_cast<float*>(dln), st);
  if (err) return err;
  return sum_rows(a.part_bias, n_win, (long long)NH * 4096, static_cast<float*>(dbias), st);
}
