// Swin-transformer window attention, inference, bf16 (sm_90a): kernel B,
// the entry kair_window_msa.
//
// Replaces kair_tpu/ops/pallas/window_msa.py :: window_msa_pallas:
// attention only, on an LN1 output,
//
//   out = roll(W-MSA(roll(y, -phase)), +phase)
//
// with the rel-pos bias, the optional 0/-100 shift mask and the softmax with
// the row max subtracted. It reads and writes the same wrapped pixels, so
// its output is un-rolled. Token t = (r, c) of window (wr, wc) is read from
// y[b, (wr*ws + r + phase) mod H, (wc*ws + c + phase) mod W] by index
// arithmetic: no roll copy and no window partition/reverse copy.
//
// A window of N = ws*ws < 64 tokens is padded to the 64 rows of the tensor-
// core tiles in shared memory: the padded rows are zero, every key j >= N
// gets a score of -inf (so it is out of the row max and adds exactly 0 to
// the sum), and only the N real rows are stored. The TPU kernel's window
// pairs, dummy window, rowsum lane and nW <= 256 cap are layout tricks of
// the TPU and have no counterpart here.
//
// Bound on the H100: ~305,000 FLOP per token at SwinIR-M width (C=180,
// 64-token windows) against 720 bytes of activations in and out, above the
// card's ~295 FLOP/byte ridge, so it is bound by tensor-core operations.
// What the design does about it: everything between the input and the
// output (q/k/v, scores, probabilities) stays in shared memory, so device
// memory sees one read and one write of the feature map; all matrix
// products run on the tensor cores in bf16 with f32 accumulation. One
// thread block of 16 warps per window, weights read from L2, shared-memory
// rows padded against bank conflicts. This is the simple first version:
// WMMA rather than wgmma/TMA, one block per SM, so it runs far from its
// bound (PERF.md). The whole block runs in swin_block_wgmma.cu.
//
// Layouts (prepared on the host, ops/kernels/window_msa.py::pack_window_msa):
//   wqkv [CP][NH*96] bf16: per head [q|k|v], 32 columns each (head dim
//        padded with zeros); the q scale folded in.
//   wp   [NH*32][CP] bf16; biases f32; relbias [NH][N][N] f32; mask
//        [nW][N][N] f32 or null. CP = C rounded up to 16.
#include "common.cuh"

using namespace kair;

namespace {

// 16 warps per window: one block per SM, so the block itself has to hide
// the latency of its loads.
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
  const float* relbias;
  const float* mask;
  int B, H, W, C, NH, phase, ws;
};

// Shared-memory layout. Every matrix row is padded by 16 bytes (kPad bf16,
// kPadF f32): at SwinIR-M width that puts each row stride 16 bytes off a
// multiple of 128, so the eight 16-byte rows a WMMA load or store touches
// at once fall in different banks (the unpadded 384-byte stride of a
// C=180 row puts them all in one).
constexpr int kPad = 8, kPadF = 4;
constexpr int kLS = 64 + kPadF;              // scores row stride, f32
constexpr int kLP = 2 * kLS;                 // probabilities row stride, bf16

// Layout: abuf [64][la] bf16 (the input, then the attention output),
// qkv [64][lq] bf16 q|k|v, s [64][kLS] f32 scores / bf16 probabilities,
// the per-warp f32 epilogue tiles and the f32 biases bqkv|bp.
struct SwinSmem {
  int la, lq;                                  // row strides (bf16 elements)
  int abuf, qkv, s, stage, cb, total;          // byte offsets
  __host__ __device__ SwinSmem(int C, int NH) {
    la = imax(round16(C), NH * 32) + kPad;
    lq = NH * 96 + kPad;
    abuf = 0;
    qkv = align128(64 * la * 2);
    s = align128(qkv + 64 * lq * 2);
    stage = align128(s + 64 * kLS * 4);
    cb = align128(stage + kWarps * kStage * 4);
    total = cb + (NH * 96 + C) * 4;
  }
};

__global__ void __launch_bounds__(kThreads) swin_window_kernel(SwinArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, CP = round16(C), NH = a.NH, H = a.H, W = a.W;
  const int ws = a.ws, N = ws * ws;
  const int QW = NH * 96;
  const SwinSmem L(C, NH);
  const int LA = L.la, LQ = L.lq;
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.abuf);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.qkv);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.s);   // row i at P + kLP*i
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __builtin_assume(warp < kWarps);
  float* stage = reinterpret_cast<float*>(smem + L.stage) + warp * kStage;
  float* bqkv = reinterpret_cast<float*>(smem + L.cb);   // epilogue biases,
  float* bp = bqkv + QW;                                 // read from shared
                                                         // memory, not L2
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
  const int C2 = C / 2;
  // the real rows, then the padded rows' zeros, in two loops: a load
  // under a per-element row test stalls this stage (the 2-D kernel's load
  // took 1.7x the cycles with the test in, KAIR_PROFILE build)
  for (int i = tid; i < N * C2; i += kThreads) {
    const int t = i / C2, p = i - t * C2;
    *reinterpret_cast<bf162*>(abuf + t * LA + 2 * p) =
        reinterpret_cast<const bf162*>(a.x + src_pixel(t) * C)[p];
  }
  for (int i = N * C2 + tid; i < 64 * C2; i += kThreads) {
    const int t = i / C2, p = i - t * C2;
    *reinterpret_cast<bf162*>(abuf + t * LA + 2 * p) = __floats2bfloat162_rn(0.f, 0.f);
  }
  for (int i = tid; i < 64 * (CP - C); i += kThreads)   // K padding of the qkv product
    abuf[(i / (CP - C)) * LA + C + i % (CP - C)] = __float2bfloat16(0.f);
  __syncthreads();

  // ---- qkv -------------------------------------------------------------------
  auto qkv_epi = [&](int r, int c, float v) {
    qkv[r * LQ + c] = __float2bfloat16(v + bqkv[c]);
  };
  gemm_m64<kWarps>(abuf, LA, a.wqkv, QW, CP / 16, QW / 16, stage, qkv_epi);
  __syncthreads();

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
  }

  // ---- proj → out, written back to the pixels it was read from ----------------
  bf16* out = a.out;
  auto out_epi = [&](int r, int c, float v) {
    if (c < C && r < N) out[src_pixel(r) * C + c] = __float2bfloat16(v + bp[c]);
  };
  gemm_m64<kWarps>(abuf, LA, a.wp, CP, NH * 2, CP / 16, stage, out_epi);
}

int launch(const SwinArgs& a, void* stream) {
  const int smem = SwinSmem(a.C, a.NH).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      swin_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)a.B * (a.H / a.ws) * (a.W / a.ws);
  swin_window_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kair_window_msa_shared_bytes(int C, int NH) {
  return SwinSmem(C, NH).total;
}

extern "C" int kair_window_msa(const void* y, void* out, const void* wqkv,
                               const void* bqkv, const void* wp, const void* bp,
                               const void* relbias, const void* mask, int B, int H,
                               int W, int C, int NH, int phase, int ws, void* stream) {
  if (ws < 1 || ws > 8) return (int)cudaErrorInvalidValue;
  SwinArgs a;
  a.x = static_cast<const bf16*>(y);
  a.out = static_cast<bf16*>(out);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.relbias = static_cast<const float*>(relbias);
  a.mask = static_cast<const float*>(mask);
  a.B = B; a.H = H; a.W = W; a.C = C; a.NH = NH; a.phase = phase; a.ws = ws;
  return launch(a, stream);
}

extern "C" const char* kair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
