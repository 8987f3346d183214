// Fused Swin-transformer block in f32, on the CUDA cores: the entry
// kair_swin_block_f32, with three modes.
//
// Replaces, for f32 inputs, kair_tpu/ops/pallas/swin_block.py ::
// swin_block_pallas_2d (_kernel_2d :174 + _block_body :68, pl.pallas_call
// :701) at window 8 and swin_block_pallas (pl.pallas_call :843) at windows
// below 8, whose bodies compute in their input's dtype; and, as the
// attention-only mode, kair_tpu/ops/pallas/window_msa.py :: window_msa_pallas
// (pl.pallas_call :271). The bf16 kernels (swin_block_wgmma.cu) round q/k/v,
// P, O and the MLP hidden layer to bf16 on the tensor cores; this one keeps
// every value f32.
//
//   whole block: out = Block(roll(x, (-phase, -phase)))  in the block's own
//     coordinates; Block: x1 = x + proj(W-MSA(LN1(x))) (rel-pos bias,
//     optional 0/-100 shift mask, softmax with the row max subtracted),
//     out = x1 + fc2(GELU(fc1(LN2(x1)))) (exact GELU, erf);
//   attention only: out = roll(proj(W-MSA(roll(y, -phase))), +phase) on an
//     LN1 output y, each token written back to the pixel it was read from.
//
// Token t = (r, c) of window (wr, wc) is read from
// x[b, (wr*ws + r + phase) mod H, (wc*ws + c + phase) mod W]. The weights are
// the parameters as they are (no LayerNorm affine folded, the q scale applied
// to q after its product), so the training backward (swin_block_bwd_f32.cu)
// reads the same pack.
//
// Bound on the H100: at SwinIR-M width (C=180, 6 heads, hidden 360, ws 8)
// the block does 564,480 FLOP per token against 1,440 bytes of f32
// activations in and out: bound by f32 operations on the CUDA cores, 2.21 ms
// at 67 TFLOP/s for B=16 of 128x128 (148 GFLOP).
//
// Design: simple first. One thread block of 256 threads per window; every
// product is kair::f32k::block_gemm (simt_f32.cuh), 4x4 register tiles of
// FFMA over operands staged 16 rows of K at a time through shared memory in
// two stages, the weights read from L2 (all of a block's weights, 1.5 MB at
// C=180, stay resident there). Shared memory holds the window's residual stream x/x1
// (NR x (C+4) f32), the LN output, one head's q, k, v and scores, and the
// staging tiles; the MLP runs in hidden chunks of 128 in the head buffers'
// bytes, so C=240 with hidden 480 (SwinIR-L) takes 187 KB and one window an
// SM. A window of N = ws*ws < 64 tokens is padded to NR = 16, 32 or 64 rows:
// the padded rows are zero, every key j >= N gets a score of -inf, and only
// the N real rows are stored. The layout is F32Plan; kair_swin_f32_plan
// reports it and ops/kernels/swin_block.py :: f32_plan mirrors it.
#include <cuda_runtime.h>

#include "simt_f32.cuh"

using namespace kair::f32k;

namespace {

constexpr int kSmemLimit = 232448;   // H100 opt-in bytes per block
constexpr int kHC = 128;             // MLP hidden chunk
constexpr int kNB = 128;             // the products' column pass

struct F32Plan {
  int nr, ldx, lds, nq, nnmax;
  int off_x, off_y, off_q, off_k, off_v, off_s, off_as, off_bs, floats;
  __host__ __device__ F32Plan(int C, int NH, int HDP, int ws) {
    const int n = ws * ws;
    nr = n <= 16 ? 16 : n <= 32 ? 32 : 64;
    ldx = C + 4;
    lds = nr + 4;
    nq = NH * 3 * HDP;
    nnmax = C > 3 * HDP ? C : 3 * HDP;
    if (nnmax < kHC) nnmax = kHC;
    if (nnmax < nr) nnmax = nr;
    off_x = 0;
    off_y = off_x + nr * ldx;
    off_q = off_y + nr * ldx;
    off_k = off_q + nr * HDP;
    off_v = off_k + nr * HDP;
    off_s = off_v + nr * HDP;
    // the MLP chunk (nr x (kHC + 4)) lies in the head buffers' bytes
    int head = 3 * nr * HDP + nr * lds;
    if (head < nr * (kHC + 4)) head = nr * (kHC + 4);
    off_as = off_q + head;
    off_bs = off_as + 2 * kKT * nr;
    floats = off_as + stage_floats(nr, nnmax, kNB);
  }
  __host__ __device__ int smem() const { return floats * 4; }
};

struct FwdArgs {
  const float* x;
  float* out;
  const float *wqkv, *bqkv, *wp, *bp, *ln, *w1, *b1, *w2, *b2, *relbias, *mask;
  int B, H, W, C, NH, HDP, hidden, phase, ws, attn_only;
  float scale;
};

// LayerNorm of rows [0, nr) of src (ld ldx) into dst, a warp a row, eps 1e-5
// (biased variance, two passes over the row).
__device__ void layer_norm_rows(const float* src, float* dst, int nr, int ldx, int C,
                                const float* g, const float* bta) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < nr; i += kThreads / 32) {
    const float* row = src + i * ldx;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mu = group_sum(s, 32) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(group_sum(v, 32) / C + 1e-5f);
    for (int c = lane; c < C; c += 32) dst[i * ldx + c] = (row[c] - mu) * rstd * g[c] + bta[c];
  }
}

__global__ void __launch_bounds__(kThreads, 1) swin_block_f32_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, HDP = a.HDP, ws = a.ws, N = ws * ws;
  const F32Plan pl(C, a.NH, HDP, ws);
  const int nr = pl.nr, ldx = pl.ldx, lds = pl.lds;
  float* X = smem + pl.off_x;   // residual stream: x, then x1, then the output
  float* Y = smem + pl.off_y;   // LN1 (or the given y), then LN2 output
  float* Q = smem + pl.off_q;   // q (scaled), then O
  float* Kh = smem + pl.off_k;
  float* V = smem + pl.off_v;
  float* S = smem + pl.off_s;   // scores, then probabilities
  float* Hc = smem + pl.off_q;  // MLP hidden chunk (after the heads)
  float* As = smem + pl.off_as;
  float* Bs = smem + pl.off_bs;

  const int nwc = a.W / ws, nw = (a.H / ws) * nwc;
  const int b = blockIdx.x / nw, wi = blockIdx.x % nw;
  const int wr = wi / nwc, wc = wi % nwc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto read_pixel = [&](int i) {   // the rolled pixel token i is read from
    const int r = i / ws, c = i % ws;
    int y = (wr * ws + r + a.phase) % a.H, xx = (wc * ws + c + a.phase) % a.W;
    y += y < 0 ? a.H : 0;
    xx += xx < 0 ? a.W : 0;
    return ((long long)b * a.H + y) * a.W + xx;
  };

  // load the window: x into X (whole block) or y into Y (attention only)
  {
    float* dst = a.attn_only ? Y : X;
    for (int i = warp; i < nr; i += kThreads / 32) {
      const float* src = a.x + read_pixel(i < N ? i : 0) * C;
      for (int c = lane; c < C; c += 32) dst[i * ldx + c] = i < N ? src[c] : 0.f;
    }
  }
  __syncthreads();
  if (!a.attn_only) {
    layer_norm_rows(X, Y, nr, ldx, C, a.ln, a.ln + C);
    __syncthreads();
  }
  // x1 accumulates from x + bp (attention only: from bp)
  for (int e = threadIdx.x; e < nr * C; e += kThreads) {
    const int i = e / C, c = e - i * C;
    X[i * ldx + c] = (a.attn_only ? 0.f : X[i * ldx + c]) + a.bp[c];
  }

  const int nq = pl.nq;
  for (int h = 0; h < a.NH; ++h) {
    // q | k | v of head h (K = C, N = 3 HDP)
    block_gemm<kNB>(Strided(Y, 1, ldx, nr), Strided(a.wqkv + h * 3 * HDP, nq, 1, 3 * HDP), C, nr,
               3 * HDP, As, Bs, [&](int r0, int n0, const float(&v)[4][4]) {
                 const int part = n0 / HDP, d0 = n0 - part * HDP;
                 float* dst = part == 0 ? Q : part == 1 ? Kh : V;
                 for (int i = 0; i < 4; ++i)
                   for (int j = 0; j < 4; ++j) {
                     const float t = v[i][j] + a.bqkv[h * 3 * HDP + n0 + j];
                     dst[(r0 + i) * HDP + d0 + j] = part == 0 ? t * a.scale : t;
                   }
               });
    // scores (K = HDP, N = nr keys) + rel-pos bias (+ mask); padded keys -inf
    const float* rb = a.relbias + (long long)h * N * N;
    const float* mk = a.mask ? a.mask + (long long)wi * N * N : nullptr;
    block_gemm<kNB>(Strided(Q, 1, HDP, nr), Strided(Kh, 1, HDP, nr), HDP, nr, nr, As, Bs,
               [&](int r0, int n0, const float(&v)[4][4]) {
                 for (int i = 0; i < 4; ++i)
                   for (int j = 0; j < 4; ++j) {
                     const int qi = r0 + i, kj = n0 + j;
                     float t = -INFINITY;
                     if (kj < N) {
                       t = v[i][j];
                       if (qi < N) t += rb[qi * N + kj] + (mk ? mk[qi * N + kj] : 0.f);
                     }
                     S[qi * lds + kj] = t;
                   }
               });
    // softmax over each row, 256 / nr threads a row (row max subtracted)
    {
      const int tpr = kThreads / nr, i = threadIdx.x / tpr, q = threadIdx.x % tpr;
      float* row = S + i * lds;
      float m = -INFINITY;
      for (int j = q; j < nr; j += tpr) m = fmaxf(m, row[j]);
      m = group_max(m, tpr);
      float s = 0.f;
      for (int j = q; j < nr; j += tpr) {
        const float e = expf(row[j] - m);
        row[j] = e;
        s += e;
      }
      const float inv = 1.f / group_sum(s, tpr);
      for (int j = q; j < nr; j += tpr) row[j] *= inv;
    }
    // O = P V (K = nr keys, N = HDP) into Q's bytes
    block_gemm<kNB>(Strided(S, 1, lds, nr), Strided(V, HDP, 1, HDP), nr, nr, HDP, As, Bs,
               [&](int r0, int n0, const float(&v)[4][4]) {
                 for (int i = 0; i < 4; ++i)
                   for (int j = 0; j < 4; ++j) Q[(r0 + i) * HDP + n0 + j] = v[i][j];
               });
    // x1 += O Wp[head h rows] (K = HDP, N = C)
    block_gemm<kNB>(Strided(Q, 1, HDP, nr), Strided(a.wp + (long long)h * HDP * C, C, 1, C), HDP,
               nr, C, As, Bs, [&](int r0, int n0, const float(&v)[4][4]) {
                 for (int i = 0; i < 4; ++i)
                   for (int j = 0; j < 4; ++j) X[(r0 + i) * ldx + n0 + j] += v[i][j];
               });
  }

  if (a.attn_only) {
    // each token back to the pixel it was read from
    for (int i = warp; i < N; i += kThreads / 32) {
      float* dst = a.out + read_pixel(i) * C;
      for (int c = lane; c < C; c += 32) dst[c] = X[i * ldx + c];
    }
    return;
  }

  // MLP: LN2, then fc1 / GELU / fc2 in hidden chunks of kHC
  layer_norm_rows(X, Y, nr, ldx, C, a.ln + 2 * C, a.ln + 3 * C);
  __syncthreads();
  for (int e = threadIdx.x; e < nr * C; e += kThreads) {
    const int i = e / C, c = e - i * C;
    X[i * ldx + c] += a.b2[c];
  }
  for (int j0 = 0; j0 < a.hidden; j0 += kHC) {
    const int nc = a.hidden - j0 < kHC ? a.hidden - j0 : kHC;
    block_gemm<kNB>(Strided(Y, 1, ldx, nr), Strided(a.w1 + j0, a.hidden, 1, nc), C, nr, nc, As, Bs,
               [&](int r0, int n0, const float(&v)[4][4]) {
                 for (int i = 0; i < 4; ++i)
                   for (int j = 0; j < 4; ++j)
                     Hc[(r0 + i) * (kHC + 4) + n0 + j] = gelu(v[i][j] + a.b1[j0 + n0 + j]);
               });
    block_gemm<kNB>(Strided(Hc, 1, kHC + 4, nr), Strided(a.w2 + (long long)j0 * C, C, 1, C), nc, nr,
               C, As, Bs, [&](int r0, int n0, const float(&v)[4][4]) {
                 for (int i = 0; i < 4; ++i)
                   for (int j = 0; j < 4; ++j) X[(r0 + i) * ldx + n0 + j] += v[i][j];
               });
  }
  // the output in the block's own coordinates
  for (int i = warp; i < N; i += kThreads / 32) {
    const int r = i / ws, c = i % ws;
    float* dst = a.out + (((long long)b * a.H + wr * ws + r) * a.W + wc * ws + c) * C;
    for (int cc = lane; cc < C; cc += 32) dst[cc] = X[i * ldx + cc];
  }
}

}  // namespace

// mode 0: the whole block (ln, w1, b1, w2, b2 read); mode 1: attention only
// on an LN1 output (those five ignored). Returns a cudaError_t.
extern "C" int kair_swin_block_f32(const void* x, void* out, const void* wqkv, const void* bqkv,
                                   const void* wp, const void* bp, const void* ln, const void* w1,
                                   const void* b1, const void* w2, const void* b2,
                                   const void* relbias, const void* mask, int B, int H, int W,
                                   int C, int NH, int HDP, int hidden, int phase, int ws, int mode,
                                   float scale, void* stream) {
  const F32Plan pl(C, NH, HDP, ws);
  if (pl.smem() > kSmemLimit || ws < 1 || ws > 8 || H % ws || W % ws || C % 4 || HDP % 4 ||
      hidden % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(swin_block_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem());
  if (e != cudaSuccess) return (int)e;
  FwdArgs a{static_cast<const float*>(x),       static_cast<float*>(out),
            static_cast<const float*>(wqkv),    static_cast<const float*>(bqkv),
            static_cast<const float*>(wp),      static_cast<const float*>(bp),
            static_cast<const float*>(ln),      static_cast<const float*>(w1),
            static_cast<const float*>(b1),      static_cast<const float*>(w2),
            static_cast<const float*>(b2),      static_cast<const float*>(relbias),
            static_cast<const float*>(mask),    B,
            H,                                  W,
            C,                                  NH,
            HDP,                                hidden,
            phase,                              ws,
            mode,                               scale};
  const int windows = B * (H / ws) * (W / ws);
  swin_block_f32_kernel<<<windows, kThreads, pl.smem(), static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The layout at C channels, NH heads of HDP padded dims, window ws: dst (host
// int[4]) = rows NR, row stride of x / LN buffers, staged B columns, shared
// bytes. Returns the shared bytes.
extern "C" int kair_swin_f32_plan(int C, int NH, int HDP, int ws, int* dst) {
  const F32Plan pl(C, NH, HDP, ws);
  dst[0] = pl.nr;
  dst[1] = pl.ldx;
  dst[2] = pl.nnmax;
  dst[3] = pl.smem();
  return pl.smem();
}
