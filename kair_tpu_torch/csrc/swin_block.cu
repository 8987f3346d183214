// Fused Swin-transformer block on an 8x8 window, inference, bf16 (sm_90a).
//
// Replaces the TPU kernel kair_tpu/ops/pallas/swin_block.py ::
// swin_block_pallas_2d (_kernel_2d + _block_body). It computes
//
//   out = Block(roll(x, (-phase, -phase)))    in the block's own coordinates,
//   Block: x1 = x + proj(W-MSA(LN1(x)))  (rel-pos bias, optional 0/-100 shift
//          mask, softmax with the row max subtracted), out = x1 + fc2(GELU(fc1(LN2(x1))))
//
// Token (r, c) of the map is read from x[b, (r+phase) mod H, (c+phase) mod W]
// by index arithmetic: no roll copy and no window partition/reverse copy.
//
// Bound on the H100: at SwinIR-M width (C=180, 64-token windows) one block
// does 564,480 FLOP per token against 720 bytes of activations in and out,
// ~780 FLOP/byte, above the card's ~295 FLOP/byte ridge, so it is bound by
// tensor-core operations (0.15 ms at 989 TFLOP/s for B=16, 128x128).
// What the design does about it: everything between the block's input and
// output (LN outputs, q/k/v, scores, probabilities, the MLP hidden layer)
// stays in shared memory, so device memory sees one read and one write of
// the feature map; all six matrix products run on the tensor cores in bf16
// with f32 accumulation. One thread block of 16 warps per window, weights
// read from L2 (about 0.6 MB in bf16), shared-memory rows padded against
// bank conflicts. This is the simple first version: WMMA rather than
// wgmma/TMA, one block per SM, so it runs far from its bound (PERF.md).
//
// Layouts (prepared on the host, ops/kernels/swin_block.py::pack_swin_block):
//   wqkv [CP][NH*96] bf16: per head [q|k|v], 32 columns each (head dim
//        padded with zeros); LN1 affine and the q scale folded in.
//   wp   [NH*32][CP] bf16, w1 [CP][HP] bf16 (LN2 affine folded), w2 [HP][CP]
//   biases f32; relbias [NH][64][64] f32; mask [nW][64][64] f32 or null.
//   CP = C rounded up to 16, HP = hidden rounded up to 16.
#include "common.cuh"

using namespace kair;

namespace {

// 16 warps per window: one block per SM (the shared memory allows no
// more), so the block itself has to hide the latency of its loads.
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

struct SwinArgs {
  const bf16* x;
  bf16* out;
  const bf16* wqkv;
  const float* bqkv;
  const bf16* wp;
  const float* bp;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const float* relbias;
  const float* mask;
  int B, H, W, C, NH, HP, phase;
};

// Shared-memory layout. Every matrix row is padded by 16 bytes (kPad bf16,
// kPadF f32): at SwinIR-M width that puts each row stride 16 bytes off a
// multiple of 128, so the eight 16-byte rows a WMMA load or store touches
// at once fall in different banks (the unpadded 384-byte stride of a
// C=180 row puts them all in one).
constexpr int kPad = 8, kPadF = 4;
constexpr int kLS = 64 + kPadF;              // scores row stride, f32
constexpr int kLP = 2 * kLS;                 // probabilities row stride, bf16

struct SwinSmem {
  int la, lq, lh;                            // row strides (bf16 elements)
  int xs, abuf, big, s, stage, cb, total;    // byte offsets
  __host__ __device__ SwinSmem(int C, int NH, int HP) {
    la = imax(round16(C), NH * 32) + kPad;
    lq = NH * 96 + kPad;
    lh = HP + kPad;
    xs = 0;                                  // [64][C]  f32 residual stream
    abuf = align128(xs + 64 * C * 4);        // [64][la] bf16 LN out / attention out
    big = align128(abuf + 64 * la * 2);      // [64][lq] bf16 qkv, later [64][lh] hidden
    s = align128(big + 64 * imax(lq, lh) * 2);  // [64][kLS] f32 scores / bf16 probs
    stage = align128(s + 64 * kLS * 4);      // per-warp f32 epilogue tiles
    cb = align128(stage + kWarps * kStage * 4);  // f32 biases bqkv|bp|b1|b2
    total = cb + (NH * 96 + C + HP + C) * 4;
  }
};

// Stage cycle profile, compiled in only with -DKAIR_PROFILE (the separate
// library that kair_tpu_torch/cli/profile_swin_block.py builds): after each
// stage's barrier, thread 0 of every block adds the SM clock cycles since
// its previous mark to that stage's counter. The normal build has no marks.
// Stages: 0 load, 1 LN1, 2 qkv, 3 QK^T, 4 softmax, 5 PV, 6 proj, 7 LN2,
// 8 fc1 + GELU, 9 fc2 + store (3-5 summed over the heads).
#ifdef KAIR_PROFILE
constexpr int kStages = 10;
__device__ unsigned long long g_stage_cycles[kStages];
#define PROF_START() long long prof_t = clock64()
#define PROF_MARK(i)                                                       \
  do {                                                                     \
    __syncthreads();                                                       \
    if (threadIdx.x == 0) {                                                \
      const long long t = clock64();                                       \
      atomicAdd(&g_stage_cycles[i], (unsigned long long)(t - prof_t));     \
      prof_t = t;                                                          \
    }                                                                      \
  } while (0)
#else
#define PROF_START() do {} while (0)
#define PROF_MARK(i) do {} while (0)
#endif

// LayerNorm without affine (folded into the next matmul) of the 64 rows of
// xs into bf16 dst[64][ld]; columns C..CP-1 are zeroed for the K padding.
__device__ void layernorm64(const float* xs, int C, int CP, bf16* dst, int ld) {
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
    for (int c = lane; c < CP; c += 32)
      dst[t * ld + c] = __float2bfloat16(c < C ? (row[c] - mean) * rstd : 0.f);
  }
}

__global__ void __launch_bounds__(kThreads) swin_block_2d_kernel(SwinArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  PROF_START();
  const int C = a.C, CP = round16(C), NH = a.NH, HP = a.HP, H = a.H, W = a.W;
  const int QW = NH * 96;
  const SwinSmem L(C, NH, HP);
  const int LA = L.la, LQ = L.lq, LH = L.lh;
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.abuf);
  bf16* big = reinterpret_cast<bf16*>(smem + L.big);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.s);   // row i at P + kLP*i
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stage = reinterpret_cast<float*>(smem + L.stage) + warp * kStage;
  float* bqkv = reinterpret_cast<float*>(smem + L.cb);   // epilogue biases,
  float* bp = bqkv + QW;                                 // read from shared
  float* b1 = bp + C;                                    // memory, not L2
  float* b2 = b1 + HP;

  const int nwc = W / 8, nwr = H / 8;
  int blk = blockIdx.x;
  const int wc = blk % nwc;
  blk /= nwc;
  const int wr = blk % nwr;
  const int b = blk / nwr;
  const int win = wr * nwc + wc;

  // ---- biases; the window (shift folded into the read) ------------------------
  for (int i = tid; i < QW; i += kThreads) bqkv[i] = a.bqkv[i];
  for (int i = tid; i < HP; i += kThreads) b1[i] = a.b1[i];
  for (int i = tid; i < C; i += kThreads) {
    bp[i] = a.bp[i];
    b2[i] = a.b2[i];
  }
  const int C2 = C / 2;
  for (int i = tid; i < 64 * C2; i += kThreads) {
    const int t = i / C2, p = i - t * C2;
    const int r = wrap(wr * 8 + (t >> 3) + a.phase, H);
    const int c = wrap(wc * 8 + (t & 7) + a.phase, W);
    const bf162 v = reinterpret_cast<const bf162*>(
        a.x + (((size_t)b * H + r) * W + c) * C)[p];
    const float2 f = __bfloat1622float2(v);
    xs[t * C + 2 * p] = f.x;
    xs[t * C + 2 * p + 1] = f.y;
  }
  __syncthreads();
  PROF_MARK(0);

  // ---- LN1 → qkv -------------------------------------------------------------
  layernorm64(xs, C, CP, abuf, LA);
  __syncthreads();
  PROF_MARK(1);
  auto qkv_epi = [&](int r, int c, float v) {
    big[r * LQ + c] = __float2bfloat16(v + bqkv[c]);
  };
  gemm_m64<kWarps>(abuf, LA, a.wqkv, QW, CP / 16, QW / 16, stage, qkv_epi);
  __syncthreads();
  PROF_MARK(2);

  // ---- attention, one head at a time -------------------------------------------
  for (int h = 0; h < NH; ++h) {
    const bf16* Q = big + h * 96;
    const bf16* K = Q + 32;
    const bf16* V = Q + 64;
    for (int tile = warp; tile < 16; tile += kWarps) {     // S = Q Kᵀ (q pre-scaled)
      const int m = tile >> 2, n = tile & 3;
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
      wmma::store_matrix_sync(S + m * 16 * kLS + n * 16, acc, kLS, wmma::mem_row_major);
    }
    __syncthreads();
    PROF_MARK(3);

    const float* bias = a.relbias + h * 4096;
    const float* mk = a.mask ? a.mask + (size_t)win * 4096 : nullptr;
    // softmax with the row max subtracted; each warp owns kRows rows and
    // issues all their bias/mask loads (L2) before it reduces any row
    constexpr int kRows = 64 / kWarps;
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = warp + j * kWarps;
      s0[j] = S[i * kLS + lane] + bias[i * 64 + lane];
      s1[j] = S[i * kLS + lane + 32] + bias[i * 64 + lane + 32];
      if (mk) {
        s0[j] += mk[i * 64 + lane];
        s1[j] += mk[i * 64 + lane + 32];
      }
    }
    __syncwarp();   // the warp's f32 rows are read before their bf16 overwrite
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = warp + j * kWarps;
      const float mx = warp_max(fmaxf(s0[j], s1[j]));
      const float e0 = __expf(s0[j] - mx), e1 = __expf(s1[j] - mx);
      const float inv = 1.f / warp_sum(e0 + e1);
      P[i * kLP + lane] = __float2bfloat16(e0 * inv);
      P[i * kLP + lane + 32] = __float2bfloat16(e1 * inv);
    }
    __syncthreads();
    PROF_MARK(4);

    auto pv_epi = [&](int r, int c, float v) { abuf[r * LA + c] = __float2bfloat16(v); };
    for (int tile = warp; tile < 8; tile += kWarps) {      // O_h = P V_h
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
    PROF_MARK(5);
  }

  // ---- proj + residual 1 (x1 stays f32 in xs) --------------------------------------
  auto proj_epi = [&](int r, int c, float v) {
    if (c < C) xs[r * C + c] += v + bp[c];
  };
  gemm_m64<kWarps>(abuf, LA, a.wp, CP, NH * 2, CP / 16, stage, proj_epi);
  __syncthreads();
  PROF_MARK(6);

  // ---- LN2 → fc1 → exact GELU → fc2 + residual 2 → out ---------------------------
  layernorm64(xs, C, CP, abuf, LA);
  __syncthreads();
  PROF_MARK(7);
  auto fc1_epi = [&](int r, int c, float v) {
    const float u = v + b1[c];
    big[r * LH + c] = __float2bfloat16(0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
  };
  gemm_m64<kWarps>(abuf, LA, a.w1, HP, CP / 16, HP / 16, stage, fc1_epi);
  __syncthreads();
  PROF_MARK(8);
  bf16* out = a.out;
  auto fc2_epi = [&](int r, int c, float v) {
    if (c < C) {
      const size_t row = (size_t)b * H + wr * 8 + (r >> 3);
      const size_t pix = row * W + wc * 8 + (r & 7);
      out[pix * C + c] = __float2bfloat16(xs[r * C + c] + v + b2[c]);
    }
  };
  gemm_m64<kWarps>(big, LH, a.w2, CP, HP / 16, CP / 16, stage, fc2_epi);
  PROF_MARK(9);
}

}  // namespace

extern "C" int kair_swin_block_shared_bytes(int C, int NH, int HP) {
  return SwinSmem(C, NH, HP).total;
}

extern "C" int kair_swin_block_2d(const void* x, void* out, const void* wqkv,
                                  const void* bqkv, const void* wp, const void* bp,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, const void* relbias, const void* mask,
                                  int B, int H, int W, int C, int NH, int HP, int phase,
                                  void* stream) {
  const int smem = SwinSmem(C, NH, HP).total;
  cudaError_t e = cudaFuncSetAttribute(
      swin_block_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  SwinArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.relbias = static_cast<const float*>(relbias);
  a.mask = static_cast<const float*>(mask);
  a.B = B; a.H = H; a.W = W; a.C = C; a.NH = NH; a.HP = HP; a.phase = phase;
  const unsigned grid = (unsigned)B * (H / 8) * (W / 8);
  swin_block_2d_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

#ifdef KAIR_PROFILE
// Copies the stage counters to dst[kStages] (host) and zeroes them.
extern "C" int kair_swin_stage_cycles(unsigned long long* dst) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_stage_cycles, sizeof(g_stage_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kStages] = {};
  return (int)cudaMemcpyToSymbol(g_stage_cycles, zero, sizeof(zero));
}
#endif

extern "C" const char* kair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
