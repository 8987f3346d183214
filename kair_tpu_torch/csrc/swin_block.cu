// Fused Swin-transformer windows, inference, bf16 (sm_90a): two entries
// built from one kernel template, three instantiations.
//
// kair_swin_block      the whole block on ws x ws windows, ws <= 8. At ws 8
//                      it launches the instantiation with the window fixed at
//                      compile time, which replaces kair_tpu/ops/pallas/
//                      swin_block.py :: swin_block_pallas_2d (_kernel_2d +
//                      _block_body); below 8 the one that takes ws at run
//                      time, which replaces swin_block.py :: swin_block_pallas
//                      (the pair _kernel; ws 7 is the JPEG-CAR geometry).
// kair_window_msa      replaces kair_tpu/ops/pallas/window_msa.py ::
//                      window_msa_pallas: attention only, on an LN1 output.
//
// The block computes
//
//   out = Block(roll(x, (-phase, -phase)))    in the block's own coordinates,
//   Block: x1 = x + proj(W-MSA(LN1(x)))  (rel-pos bias, optional 0/-100 shift
//          mask, softmax with the row max subtracted), out = x1 + fc2(GELU(fc1(LN2(x1))))
//
// and the attention-only entry  out = roll(W-MSA(roll(y, -phase)), +phase):
// it reads and writes the same wrapped pixels, so its output is un-rolled.
// Token t = (r, c) of window (wr, wc) is read from
// x[b, (wr*ws + r + phase) mod H, (wc*ws + c + phase) mod W] by index
// arithmetic: no roll copy and no window partition/reverse copy.
//
// A window of N = ws*ws < 64 tokens is padded to the 64 rows of the tensor-
// core tiles in shared memory: the padded rows are zero, every key j >= N
// gets a score of -inf (so it is out of the row max and adds exactly 0 to
// the sum), and only the N real rows are stored. The TPU kernel's window
// pairs, dummy window, rowsum lane and nW <= 256 cap are layout tricks of
// the TPU and have no counterpart here.
//
// Bound on the H100: at SwinIR-M width (C=180, 64-token windows) one block
// does 564,480 FLOP per token against 720 bytes of activations in and out,
// ~780 FLOP/byte, above the card's ~295 FLOP/byte ridge, so it is bound by
// tensor-core operations (0.15 ms at 989 TFLOP/s for B=16, 128x128); the
// attention-only entry (~305,000 FLOP per token, 720 bytes) likewise.
// What the design does about it: everything between the input and the
// output (LN outputs, q/k/v, scores, probabilities, the MLP hidden layer)
// stays in shared memory, so device memory sees one read and one write of
// the feature map; all matrix products run on the tensor cores in bf16
// with f32 accumulation. One thread block of 16 warps per window, weights
// read from L2 (about 0.6 MB in bf16 at C=180), shared-memory rows padded
// against bank conflicts. This is the simple first version: WMMA rather
// than wgmma/TMA, one block per SM, so it runs far from its bound (PERF.md).
//
// Layouts (prepared on the host, ops/kernels/swin_block.py::pack_swin_block
// and ops/kernels/window_msa.py::pack_window_msa):
//   wqkv [CP][NH*96] bf16: per head [q|k|v], 32 columns each (head dim
//        padded with zeros); the q scale folded in, and for the block the
//        LN1 affine too.
//   wp   [NH*32][CP] bf16, w1 [CP][HP] bf16 (LN2 affine folded), w2 [HP][CP]
//   biases f32; relbias [NH][N][N] f32; mask [nW][N][N] f32 or null.
//   CP = C rounded up to 16, HP = hidden rounded up to 16.
#include "common.cuh"

using namespace kair;

namespace {

// 16 warps per window: one block per SM (the shared memory allows no
// more), so the block itself has to hide the latency of its loads.
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemLimit = 232448;           // H100 opt-in bytes per block

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
  int B, H, W, C, NH, HP, phase, ws;
};

// Shared-memory layout. Every matrix row is padded by 16 bytes (kPad bf16,
// kPadF f32): at SwinIR-M width that puts each row stride 16 bytes off a
// multiple of 128, so the eight 16-byte rows a WMMA load or store touches
// at once fall in different banks (the unpadded 384-byte stride of a
// C=180 row puts them all in one).
constexpr int kPad = 8, kPadF = 4;
constexpr int kLS = 64 + kPadF;              // scores row stride, f32
constexpr int kLP = 2 * kLS;                 // probabilities row stride, bf16

// The block (block = true) lets buffers whose live ranges do not overlap
// share bytes. Stages and what is live across each:
//   load, LN1      xb                     (abuf written)
//   qkv            abuf -> qkv
//   attention      xb, qkv, s, abuf
//   proj           abuf, xb -> x1         (qkv and s dead: x1 may overlap qkv)
//   LN2, fc1       x1, abuf -> hid        (xb dead: hid may overlap s, xb, qkv)
//   fc2            hid, x1 -> out
// The block input stays bf16 in xb (it is exact there: x is bf16), and only
// x1 = x + attention is kept in f32. So SwinIR-L (C=240, 8 heads, hidden
// 480) asks 204,544 bytes and SwinIR-M 162,400; a layout with an f32 x
// live through the attention asked 235,264 and 185,440.
// The attention-only entry (block = false) reads its input into abuf and
// needs no residual stream.
struct SwinSmem {
  int la, lq, lh;                              // row strides (bf16 elements)
  int s, xb, qkv, x1, hid, abuf, stage, cb, total;   // byte offsets
  __host__ __device__ SwinSmem(int C, int NH, int HP, bool block) {
    la = imax(round16(C), NH * 32) + kPad;
    lq = NH * 96 + kPad;
    lh = HP + kPad;
    if (block) {
      s = 0;                                   // [64][kLS] f32 scores / bf16 probs
      xb = align128(64 * kLS * 4);             // [64][C] bf16 block input
      qkv = align128(xb + 64 * C * 2);         // [64][lq] bf16 q|k|v
      hid = 0;                                 // [64][lh] bf16 MLP hidden
      x1 = align128(imax(xb + 64 * C * 2, 64 * lh * 2));   // [64][C] f32 x1
      abuf = align128(imax(qkv + 64 * lq * 2, x1 + 64 * C * 4));
    } else {
      xb = x1 = hid = 0;                       // unused
      abuf = 0;                                // [64][la] input, attention out
      qkv = align128(64 * la * 2);
      s = align128(qkv + 64 * lq * 2);
    }
    // abuf: [64][la] bf16 LN1/LN2 out, attention out; then the per-warp f32
    // epilogue tiles and the f32 biases bqkv|bp[|b1|b2]
    const int end = block ? abuf + 64 * la * 2 : s + 64 * kLS * 4;
    stage = align128(end);
    cb = align128(stage + kWarps * kStage * 4);
    total = cb + (NH * 96 + C + (block ? HP + C : 0)) * 4;
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

static __device__ __forceinline__ float to_f(float v) { return v; }
static __device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// LayerNorm without affine (folded into the next matmul) of the 64 rows of
// src[64][C] (bf16 or f32) into bf16 dst[64][ld]; columns C..CP-1 are
// zeroed for the K padding.
template <class T>
__device__ void layernorm64(const T* src, int C, int CP, bf16* dst, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < 64; t += kWarps) {
    const T* row = src + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(row[c]);
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(row[c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
    for (int c = lane; c < CP; c += 32)
      dst[t * ld + c] = __float2bfloat16(
          c < C ? (to_f(row[c]) - mean) * rstd : 0.f);
  }
}

// WS_T: the window side at compile time (8: the block at ws 8), or 0 for
// the run-time a.ws (the block below ws 8, and attention). BLOCK: the whole
// block, or attention only.
template <int WS_T, bool BLOCK>
__global__ void __launch_bounds__(kThreads) swin_window_kernel(SwinArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  PROF_START();
  const int C = a.C, CP = round16(C), NH = a.NH, HP = a.HP, H = a.H, W = a.W;
  const int ws = WS_T ? WS_T : a.ws, N = ws * ws;
  const int QW = NH * 96;
  const SwinSmem L(C, NH, HP, BLOCK);
  const int LA = L.la, LQ = L.lq, LH = L.lh;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  float* x1 = reinterpret_cast<float*>(smem + L.x1);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.abuf);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.qkv);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.s);   // row i at P + kLP*i
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // with the window at 8 this folds every padded-row test of the softmax
  __builtin_assume(warp < kWarps);
  float* stage = reinterpret_cast<float*>(smem + L.stage) + warp * kStage;
  float* bqkv = reinterpret_cast<float*>(smem + L.cb);   // epilogue biases,
  float* bp = bqkv + QW;                                 // read from shared
  float* b1 = bp + C;                                    // memory, not L2
  float* b2 = b1 + HP;

  const int nwc = W / ws, nwr = H / ws;
  int blk = blockIdx.x;
  const int wc = blk % nwc;
  blk /= nwc;
  const int wr = blk % nwr;
  const int b = blk / nwr;
  const int win = wr * nwc + wc;
  // token t < N of the window: its map pixel with the phase folded in
  auto src_pixel = [&](int t) -> size_t {
    const int r = wrap(wr * ws + t / ws + a.phase, H);
    const int c = wrap(wc * ws + t % ws + a.phase, W);
    return ((size_t)b * H + r) * W + c;
  };

  // ---- biases; the window (shift folded into the read) ------------------------
  for (int i = tid; i < QW; i += kThreads) bqkv[i] = a.bqkv[i];
  for (int i = tid; i < C; i += kThreads) bp[i] = a.bp[i];
  if (BLOCK) {
    for (int i = tid; i < HP; i += kThreads) b1[i] = a.b1[i];
    for (int i = tid; i < C; i += kThreads) b2[i] = a.b2[i];
  }
  const int C2 = C / 2;
  bf16* dst = BLOCK ? xb : abuf;                 // block input / LN1 output
  const int ld = BLOCK ? C : LA;
  // the real rows, then the padded rows' zeros, in two loops: a load
  // under a per-element row test stalls this stage (the 2-D kernel's load
  // took 1.7x the cycles with the test in, KAIR_PROFILE build)
  for (int i = tid; i < N * C2; i += kThreads) {
    const int t = i / C2, p = i - t * C2;
    *reinterpret_cast<bf162*>(dst + t * ld + 2 * p) =
        reinterpret_cast<const bf162*>(a.x + src_pixel(t) * C)[p];
  }
  for (int i = N * C2 + tid; i < 64 * C2; i += kThreads) {
    const int t = i / C2, p = i - t * C2;
    *reinterpret_cast<bf162*>(dst + t * ld + 2 * p) = __floats2bfloat162_rn(0.f, 0.f);
  }
  if (!BLOCK)                                     // K padding of the qkv product
    for (int i = tid; i < 64 * (CP - C); i += kThreads)
      abuf[(i / (CP - C)) * LA + C + i % (CP - C)] = __float2bfloat16(0.f);
  __syncthreads();
  PROF_MARK(0);

  // ---- LN1 → qkv -------------------------------------------------------------
  if (BLOCK) {
    layernorm64(xb, C, CP, abuf, LA);
    __syncthreads();
  }
  PROF_MARK(1);
  auto qkv_epi = [&](int r, int c, float v) {
    qkv[r * LQ + c] = __float2bfloat16(v + bqkv[c]);
  };
  gemm_m64<kWarps>(abuf, LA, a.wqkv, QW, CP / 16, QW / 16, stage, qkv_epi);
  __syncthreads();
  PROF_MARK(2);

  // ---- attention, one head at a time -------------------------------------------
  for (int h = 0; h < NH; ++h) {
    const bf16* Q = qkv + h * 96;
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

    const float* bias = a.relbias + (size_t)h * N * N;
    const float* mk = a.mask ? a.mask + (size_t)win * N * N : nullptr;
    // softmax with the row max subtracted; each warp owns kRows rows and
    // issues all their bias/mask loads (L2) before it reduces any row.
    // Keys j >= N are padding: -inf, so they are out of the max and the sum;
    // padded query rows i >= N take no bias and are never stored.
    constexpr int kRows = 64 / kWarps;
    const float kNegInf = __int_as_float(0xff800000);
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = warp + j * kWarps;
      s0[j] = S[i * kLS + lane];
      s1[j] = S[i * kLS + lane + 32];
      if (i < N) {
        if (lane < N) s0[j] += bias[i * N + lane] + (mk ? mk[i * N + lane] : 0.f);
        if (lane + 32 < N)
          s1[j] += bias[i * N + lane + 32] + (mk ? mk[i * N + lane + 32] : 0.f);
      }
      if (lane >= N) s0[j] = kNegInf;
      if (lane + 32 >= N) s1[j] = kNegInf;
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

  if (!BLOCK) {
    // ---- proj → out, written back to the pixels it was read from ----------------
    bf16* out = a.out;
    auto out_epi = [&](int r, int c, float v) {
      if (c < C && r < N) out[src_pixel(r) * C + c] = __float2bfloat16(v + bp[c]);
    };
    gemm_m64<kWarps>(abuf, LA, a.wp, CP, NH * 2, CP / 16, stage, out_epi);
    return;
  }

  // ---- proj + residual 1 (x1 in f32) -----------------------------------------------
  auto proj_epi = [&](int r, int c, float v) {
    if (c < C) x1[r * C + c] = __bfloat162float(xb[r * C + c]) + v + bp[c];
  };
  gemm_m64<kWarps>(abuf, LA, a.wp, CP, NH * 2, CP / 16, stage, proj_epi);
  __syncthreads();
  PROF_MARK(6);

  // ---- LN2 → fc1 → exact GELU → fc2 + residual 2 → out ---------------------------
  layernorm64(x1, C, CP, abuf, LA);
  __syncthreads();
  PROF_MARK(7);
  auto fc1_epi = [&](int r, int c, float v) {
    const float u = v + b1[c];
    hid[r * LH + c] = __float2bfloat16(0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
  };
  gemm_m64<kWarps>(abuf, LA, a.w1, HP, CP / 16, HP / 16, stage, fc1_epi);
  __syncthreads();
  PROF_MARK(8);
  bf16* out = a.out;
  auto fc2_epi = [&](int r, int c, float v) {
    if (c < C && r < N) {                        // the block's own coordinates
      const size_t row = (size_t)b * H + wr * ws + r / ws;
      const size_t pix = row * W + wc * ws + r % ws;
      out[pix * C + c] = __float2bfloat16(x1[r * C + c] + v + b2[c]);
    }
  };
  gemm_m64<kWarps>(hid, LH, a.w2, CP, HP / 16, CP / 16, stage, fc2_epi);
  PROF_MARK(9);
}

template <int WS_T, bool BLOCK>
int launch(const SwinArgs& a, void* stream) {
  const int smem = SwinSmem(a.C, a.NH, a.HP, BLOCK).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      swin_window_kernel<WS_T, BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)a.B * (a.H / a.ws) * (a.W / a.ws);
  swin_window_kernel<WS_T, BLOCK>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

SwinArgs block_args(const void* x, void* out, const void* wqkv, const void* bqkv,
                    const void* wp, const void* bp, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* relbias,
                    const void* mask, int B, int H, int W, int C, int NH, int HP,
                    int phase, int ws) {
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
  a.ws = ws;
  return a;
}

}  // namespace

extern "C" int kair_swin_block_shared_bytes(int C, int NH, int HP) {
  return SwinSmem(C, NH, HP, true).total;
}

extern "C" int kair_window_msa_shared_bytes(int C, int NH) {
  return SwinSmem(C, NH, 0, false).total;
}

extern "C" int kair_swin_block(const void* x, void* out, const void* wqkv,
                               const void* bqkv, const void* wp, const void* bp,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* relbias, const void* mask,
                               int B, int H, int W, int C, int NH, int HP, int phase,
                               int ws, void* stream) {
  if (ws < 1 || ws > 8) return (int)cudaErrorInvalidValue;
  const SwinArgs a = block_args(x, out, wqkv, bqkv, wp, bp, w1, b1, w2, b2, relbias,
                                mask, B, H, W, C, NH, HP, phase, ws);
  return ws == 8 ? launch<8, true>(a, stream) : launch<0, true>(a, stream);
}

extern "C" int kair_window_msa(const void* y, void* out, const void* wqkv,
                               const void* bqkv, const void* wp, const void* bp,
                               const void* relbias, const void* mask, int B, int H,
                               int W, int C, int NH, int phase, int ws, void* stream) {
  if (ws < 1 || ws > 8) return (int)cudaErrorInvalidValue;
  return launch<0, false>(block_args(y, out, wqkv, bqkv, wp, bp, nullptr, nullptr,
                                     nullptr, nullptr, relbias, mask, B, H, W, C,
                                     NH, 0, phase, ws),
                          stream);
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
