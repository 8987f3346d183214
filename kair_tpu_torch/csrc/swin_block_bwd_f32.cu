// Backward of the training Swin block in f32, on the CUDA cores: the entry
// kair_swin_block_2d_bwd_f32.
//
// Replaces, for f32 inputs, kair_tpu/ops/pallas/swin_block.py ::
// _fused_2d_bwd_pallas (TPU body _kernel_2d_bwd :219, pl.pallas_call :588):
// window 8, the block's shift folded into the read of x (token t = (r, c) of
// window (wr, wc) read from x[b, (8 wr + r + phase) mod H, (8 wc + c +
// phase) mod W]), dy in the block's own coordinates, dx written to the
// pixels x was read from. It returns dx, the grads of every weight and bias
// (the four products' D below), of both LayerNorms and of the score bias
// (nh, 64, 64), which ops/kernels/swin_block.py sums into the relative-
// position table. The pack is the forward's (swin_block_f32.cu): the raw
// parameters, the q scale applied after the qkv product.
//
// Bound on the H100: at SwinIR-M width and B=32 of 48x48 (the x4 recipe's
// step) the forward recomputed and the backward are 116 GFLOP: bound by f32
// operations on the CUDA cores, 1.73 ms at 67 TFLOP/s.
//
// Design: simple first, three launches and a reduction.
//  Pass 1, swin_bwd_f32_kernel: a persistent grid (one block of 256 threads
//    an SM, windows blockIdx.x, + gridDim.x, ...). Per window it recomputes
//    the forward (LN1, each head's q, k, v, P, O, proj, LN2; q, k, v and P
//    kept in device memory for the attention's backward) and then runs
//    the chain back: the MLP in hidden chunks of 128 (fc1 again, dh = dy W2^T,
//    dpre = dh GELU'(pre), dLN2 += dpre W1^T), LN2's backward, then per head
//    dO = dx1 Wp^T, dP = dO V^T, dS = P (dP - rowsum(dP P)), dV = P^T dO,
//    dQ = dS K, dK = dS^T Q, dLN1 += dqkv Wqkv^T, and LN1's backward into dx.
//    Every product is kair::f32k::block_gemm (simt_f32.cuh). Shared memory
//    holds two (64, C+4) f32 maps (x1 / dLN1 and LN1 / dLN2 / dx1), one
//    head's q, k, v, P, dP and dO, and the staging tiles (213 KB at C=240);
//    the layer inputs and output grads of the four weight products go to a
//    window-ordered operand buffer in device memory (Y1, O, Y2, GELU out, dpre,
//    dx1, dqkv and a copy of dy; 8.8 KB a token at C=180), from which the
//    block also reads back what does not fit (Y1 and Y2, dy, dqkv, and each
//    head's q, k, v and P, 3.9 KB a token more). The LN
//    and score-bias grads add into the block's own slice of a partial
//    buffer, in the same order every run.
//  Pass 2, swin_wgrad_f32_kernel: the four weight products D = A^T G over
//    all tokens (A with a column of ones for the bias), 64 x 128 tiles of D,
//    the tokens split into `splits` ranges, each range's sum a partial.
//  sum_parts_kernel adds the partials of both passes in a fixed order: no
//    atomics, so two runs give the same bits.
#include <cuda_runtime.h>

#include "simt_f32.cuh"

using namespace kair::f32k;

namespace {

constexpr int kSmemLimit = 232448;
constexpr int kHC = 128;    // MLP hidden chunk
constexpr int kHL = kHC + 4;   // its row stride (in the head buffers' bytes)
constexpr int kL = 68;      // row stride of the 64-wide head buffers
constexpr int kWR = 64, kWC = 128;   // pass-2 tile of D
constexpr int kNB = 128;    // pass 1's column pass (its staging fits at C=240)

struct BwdF32Plan {
  int ldx, nq, nnmax;
  int off_r0, off_r1, off_q, off_k, off_v, off_s, off_d, off_do, off_st, off_as, off_bs, floats;
  __host__ __device__ BwdF32Plan(int C, int NH, int HDP) {
    ldx = C + 4;
    nq = NH * 3 * HDP;
    nnmax = C > 3 * HDP ? C : 3 * HDP;
    if (nnmax < kHC) nnmax = kHC;
    off_r0 = 0;
    off_r1 = off_r0 + 64 * ldx;
    off_q = off_r1 + 64 * ldx;
    off_k = off_q + 64 * HDP;
    off_v = off_k + 64 * HDP;
    off_s = off_v + 64 * HDP;
    off_d = off_s + 64 * kL;
    off_do = off_d + 64 * kL;
    off_st = off_do + 64 * HDP;
    off_as = off_st + 4 * 64;
    off_bs = off_as + 2 * kKT * 64;
    floats = off_as + stage_floats(64, nnmax, kNB);
  }
  __host__ __device__ int smem() const { return floats * 4; }
};

// Floats of one head's q, k, v and P as pass 1 keeps them for a window:
// the shared-memory image from q to the scores' last row.
__host__ __device__ int head_floats(int HDP) { return 3 * 64 * HDP + 64 * kL; }

// Floats of the window-ordered operand buffer per token: Y1, O, Y2, GELU
// out, dpre, dx1, dqkv, dy, then every head's q, k, v and P.
__host__ __device__ int op_floats(int C, int NH, int HDP, int hidden) {
  return C + NH * HDP + C + hidden + hidden + C + NH * 3 * HDP + C +
         NH * head_floats(HDP) / 64;
}

// The four weight products (layer input A with its ones column, output
// grad G): rows Kin + 1, columns Nout, and where A and G start in ops.
struct Products {
  int kin[4], nout[4];
  long long a_off[4], g_off[4], d_off[4];
  long long total;
  __host__ __device__ Products(long long T, int C, int NH, int HDP, int hidden) {
    const int nhd = NH * HDP, nq = 3 * nhd;
    const long long y1 = 0, o = y1 + T * C, y2 = o + T * nhd, hh = y2 + T * C,
                    dh = hh + T * hidden, da = dh + T * hidden, dq = da + T * C, dy = dq + T * nq;
    const int ki[4] = {C, nhd, C, hidden}, no[4] = {nq, C, hidden, C};
    const long long ao[4] = {y1, o, y2, hh}, go[4] = {dq, da, dh, dy};
    total = 0;
    for (int p = 0; p < 4; ++p) {
      kin[p] = ki[p];
      nout[p] = no[p];
      a_off[p] = ao[p];
      g_off[p] = go[p];
      d_off[p] = total;
      total += (long long)(ki[p] + 1) * no[p];
    }
  }
  __host__ __device__ int tiles(int p) const {
    return ((kin[p] + 1 + kWR - 1) / kWR) * ((nout[p] + kWC - 1) / kWC);
  }
};

struct BwdArgs {
  const float *x, *dy;
  const float *wqkv, *bqkv, *wp, *bp, *ln, *w1, *b1, *w2, *b2, *relbias, *mask;
  float *ops, *part_bias, *part_ln, *dx;
  int B, H, W, C, NH, HDP, hidden, phase;
  float scale;
};

__global__ void __launch_bounds__(kThreads, 1) swin_bwd_f32_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, NH = a.NH, HDP = a.HDP, hid = a.hidden;
  const BwdF32Plan pl(C, NH, HDP);
  const int ldx = pl.ldx, nq = pl.nq, nhd = NH * HDP;
  float* R0 = smem + pl.off_r0;   // x1, then dLN1
  float* R1 = smem + pl.off_r1;   // LN1 out, then dLN2, then dx1
  float* Q = smem + pl.off_q;     // q (scaled); the MLP chunk in the phase between
  float* Kh = smem + pl.off_k;
  float* V = smem + pl.off_v;
  float* S = smem + pl.off_s;     // scores, then P
  float* D = smem + pl.off_d;     // dP, then dS
  float* dO = smem + pl.off_do;   // O in the recompute, then dO
  float* mu1 = smem + pl.off_st;
  float* rs1 = mu1 + 64;
  float* mu2 = rs1 + 64;
  float* rs2 = mu2 + 64;
  float* As = smem + pl.off_as;
  float* Bs = smem + pl.off_bs;
  float* Hc = Q;

  const long long T = (long long)a.B * a.H * a.W;
  float* Y1g = a.ops;
  float* Og = Y1g + T * C;
  float* Y2g = Og + T * nhd;
  float* Hg = Y2g + T * C;
  float* DHg = Hg + T * hid;
  float* DAg = DHg + T * hid;
  float* DQg = DAg + T * C;
  float* DYg = DQg + T * nq;
  const int hf = head_floats(HDP);
  float* pb = a.part_bias + (long long)blockIdx.x * NH * 4096;
  float* pln = a.part_ln + (long long)blockIdx.x * 4 * C;
  const float *g1 = a.ln, *g2 = a.ln + 2 * C;

  const int nwc = a.W / 8, nw = (a.H / 8) * nwc, nwin = a.B * nw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int win = blockIdx.x; win < nwin; win += gridDim.x) {
    const int b = win / nw, wi = win % nw, wr = wi / nwc, wc = wi % nwc;
    const long long t0 = (long long)win * 64;
    auto read_pixel = [&](int i) {
      int y = (wr * 8 + i / 8 + a.phase) % a.H, xx = (wc * 8 + i % 8 + a.phase) % a.W;
      y += y < 0 ? a.H : 0;
      xx += xx < 0 ? a.W : 0;
      return ((long long)b * a.H + y) * a.W + xx;
    };
    auto out_pixel = [&](int i) {
      return ((long long)b * a.H + wr * 8 + i / 8) * a.W + wc * 8 + i % 8;
    };
    const float* rb = a.relbias;
    const float* mk = a.mask ? a.mask + (long long)wi * 4096 : nullptr;
    // this window's q, k, v and P of every head, from the forward below to
    // the attention's backward (in place of recomputing them)
    float* QKVPg = DYg + T * C + (long long)win * NH * hf;
    auto copy4 = [&](float* dst, const float* src) {
      for (int e = threadIdx.x; e < hf / 4; e += kThreads)
        reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
    };

    // the window's x (rolled read) and a window-ordered copy of its dy
    __syncthreads();
    for (int i = warp; i < 64; i += kThreads / 32) {
      const float* xs = a.x + read_pixel(i) * C;
      const float* ds = a.dy + out_pixel(i) * C;
      for (int c = lane; c < C; c += 32) {
        R0[i * ldx + c] = xs[c];
        DYg[(t0 + i) * C + c] = ds[c];
      }
    }
    __syncthreads();

    // LN1 into R1 and Y1g, its statistics kept; x1 starts at x + bp
    for (int i = warp; i < 64; i += kThreads / 32) {
      const float* row = R0 + i * ldx;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += row[c];
      const float mu = group_sum(s, 32) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) v += (row[c] - mu) * (row[c] - mu);
      const float rstd = rsqrtf(group_sum(v, 32) / C + 1e-5f);
      if (lane == 0) {
        mu1[i] = mu;
        rs1[i] = rstd;
      }
      for (int c = lane; c < C; c += 32) {
        const float y = (row[c] - mu) * rstd * g1[c] + a.ln[C + c];
        R1[i * ldx + c] = y;
        Y1g[(t0 + i) * C + c] = y;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * C; e += kThreads) {
      const int i = e / C, c = e - i * C;
      R0[i * ldx + c] += a.bp[c];
    }

    // q | k | v of head h from LN1 out (in smem or read back), then P
    auto head_forward = [&](int h, const Strided& y1) {
      block_gemm<kNB>(y1, Strided(a.wqkv + h * 3 * HDP, nq, 1, 3 * HDP), C, 64, 3 * HDP, As, Bs,
                 [&](int r0, int n0, const float(&v)[4][4]) {
                   const int part = n0 / HDP, d0 = n0 - part * HDP;
                   float* dst = part == 0 ? Q : part == 1 ? Kh : V;
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) {
                       const float t = v[i][j] + a.bqkv[h * 3 * HDP + n0 + j];
                       dst[(r0 + i) * HDP + d0 + j] = part == 0 ? t * a.scale : t;
                     }
                 });
      block_gemm<kNB>(Strided(Q, 1, HDP, 64), Strided(Kh, 1, HDP, 64), HDP, 64, 64, As, Bs,
                 [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) {
                       const int e = (r0 + i) * 64 + n0 + j;
                       S[(r0 + i) * kL + n0 + j] =
                           v[i][j] + rb[h * 4096 + e] + (mk ? mk[e] : 0.f);
                     }
                 });
      const int i = threadIdx.x / 4, q = threadIdx.x % 4;
      float* row = S + i * kL;
      float m = -INFINITY;
      for (int j = q; j < 64; j += 4) m = fmaxf(m, row[j]);
      m = group_max(m, 4);
      float s = 0.f;
      for (int j = q; j < 64; j += 4) {
        const float e = expf(row[j] - m);
        row[j] = e;
        s += e;
      }
      const float inv = 1.f / group_sum(s, 4);
      for (int j = q; j < 64; j += 4) row[j] *= inv;
    };

    // the attention forward: O to Og, x1 += O Wp
    for (int h = 0; h < NH; ++h) {
      head_forward(h, Strided(R1, 1, ldx, 64));
      block_gemm<kNB>(Strided(S, 1, kL, 64), Strided(V, HDP, 1, HDP), 64, 64, HDP, As, Bs,
                 [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) {
                       dO[(r0 + i) * HDP + n0 + j] = v[i][j];
                       Og[(t0 + r0 + i) * nhd + h * HDP + n0 + j] = v[i][j];
                     }
                 });
      copy4(QKVPg + h * hf, Q);   // q, k, v and the scores' bytes: contiguous
      block_gemm<kNB>(Strided(dO, 1, HDP, 64), Strided(a.wp + (long long)h * HDP * C, C, 1, C), HDP,
                 64, C, As, Bs, [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) R0[(r0 + i) * ldx + n0 + j] += v[i][j];
                 });
    }

    // LN2 of x1 into Y2g, its statistics kept; R1 becomes dLN2
    for (int i = warp; i < 64; i += kThreads / 32) {
      const float* row = R0 + i * ldx;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += row[c];
      const float mu = group_sum(s, 32) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) v += (row[c] - mu) * (row[c] - mu);
      const float rstd = rsqrtf(group_sum(v, 32) / C + 1e-5f);
      if (lane == 0) {
        mu2[i] = mu;
        rs2[i] = rstd;
      }
      for (int c = lane; c < C; c += 32) {
        Y2g[(t0 + i) * C + c] = (row[c] - mu) * rstd * g2[c] + a.ln[3 * C + c];
        R1[i * ldx + c] = 0.f;
      }
    }

    // the MLP back, a hidden chunk at a time
    for (int j0 = 0; j0 < hid; j0 += kHC) {
      const int nc = hid - j0 < kHC ? hid - j0 : kHC;
      block_gemm<kNB>(Strided(Y2g + t0 * C, 1, C, 64), Strided(a.w1 + j0, hid, 1, nc), C, 64, nc, As,
                 Bs, [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) {
                       const float pre = v[i][j] + a.b1[j0 + n0 + j];
                       Hc[(r0 + i) * kHL + n0 + j] = pre;
                       Hg[(t0 + r0 + i) * hid + j0 + n0 + j] = gelu(pre);
                     }
                 });
      block_gemm<kNB>(Strided(DYg + t0 * C, 1, C, 64), Strided(a.w2 + (long long)j0 * C, 1, C, nc), C,
                 64, nc, As, Bs, [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) {
                       float* hc = Hc + (r0 + i) * kHL + n0 + j;
                       const float g = v[i][j] * gelu_grad(*hc);
                       *hc = g;
                       DHg[(t0 + r0 + i) * hid + j0 + n0 + j] = g;
                     }
                 });
      block_gemm<kNB>(Strided(Hc, 1, kHL, 64), Strided(a.w1 + j0, 1, hid, C), nc, 64, C, As, Bs,
                 [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) R1[(r0 + i) * ldx + n0 + j] += v[i][j];
                 });
    }

    // LN2 back: its parameters' grads, then dx1 = dy + dLN2 through the norm
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float sw = 0.f, sb = 0.f;
      for (int i = 0; i < 64; ++i) {
        const float g = R1[i * ldx + c];
        sw += g * (R0[i * ldx + c] - mu2[i]) * rs2[i];
        sb += g;
      }
      pln[2 * C + c] += sw;
      pln[3 * C + c] += sb;
    }
    __syncthreads();
    for (int i = warp; i < 64; i += kThreads / 32) {
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float g = R1[i * ldx + c] * g2[c];
        s1 += g;
        s2 += g * (R0[i * ldx + c] - mu2[i]) * rs2[i];
      }
      const float m1 = group_sum(s1, 32) / C, m2 = group_sum(s2, 32) / C;
      for (int c = lane; c < C; c += 32) {
        const float xh = (R0[i * ldx + c] - mu2[i]) * rs2[i];
        const float d = DYg[(t0 + i) * C + c] + rs2[i] * (R1[i * ldx + c] * g2[c] - m1 - xh * m2);
        R1[i * ldx + c] = d;
        DAg[(t0 + i) * C + c] = d;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * C; e += kThreads) {
      const int i = e / C, c = e - i * C;
      R0[i * ldx + c] = 0.f;
    }

    // the attention back, a head at a time
    for (int h = 0; h < NH; ++h) {
      __syncthreads();
      copy4(Q, QKVPg + h * hf);
      block_gemm<kNB>(Strided(R1, 1, ldx, 64), Strided(a.wp + (long long)h * HDP * C, 1, C, HDP), C,
                 64, HDP, As, Bs, [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) dO[(r0 + i) * HDP + n0 + j] = v[i][j];
                 });
      block_gemm<kNB>(Strided(dO, 1, HDP, 64), Strided(V, 1, HDP, 64), HDP, 64, 64, As, Bs,
                 [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) D[(r0 + i) * kL + n0 + j] = v[i][j];
                 });
      {
        const int i = threadIdx.x / 4, q = threadIdx.x % 4;
        float s = 0.f;
        for (int j = q; j < 64; j += 4) s += D[i * kL + j] * S[i * kL + j];
        s = group_sum(s, 4);
        for (int j = q; j < 64; j += 4) {
          const float g = S[i * kL + j] * (D[i * kL + j] - s);
          D[i * kL + j] = g;
          pb[h * 4096 + i * 64 + j] += g;
        }
      }
      float* dq = DQg + t0 * nq + h * 3 * HDP;
      block_gemm<kNB>(Strided(S, kL, 1, 64), Strided(dO, HDP, 1, HDP), 64, 64, HDP, As, Bs,
                 [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) dq[(r0 + i) * nq + 2 * HDP + n0 + j] = v[i][j];
                 });
      block_gemm<kNB>(Strided(D, 1, kL, 64), Strided(Kh, HDP, 1, HDP), 64, 64, HDP, As, Bs,
                 [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) dq[(r0 + i) * nq + n0 + j] = v[i][j] * a.scale;
                 });
      block_gemm<kNB>(Strided(D, kL, 1, 64), Strided(Q, HDP, 1, HDP), 64, 64, HDP, As, Bs,
                 [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) dq[(r0 + i) * nq + HDP + n0 + j] = v[i][j];
                 });
      block_gemm<kNB>(Strided(dq, 1, nq, 64), Strided(a.wqkv + h * 3 * HDP, 1, nq, C), 3 * HDP, 64, C,
                 As, Bs, [&](int r0, int n0, const float(&v)[4][4]) {
                   for (int i = 0; i < 4; ++i)
                     for (int j = 0; j < 4; ++j) R0[(r0 + i) * ldx + n0 + j] += v[i][j];
                 });
    }

    // LN1 back: its parameters' grads, then dx = dx1 + dLN1 through the norm
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float sw = 0.f, sb = 0.f;
      for (int i = 0; i < 64; ++i) {
        const float g = R0[i * ldx + c];
        sw += g * (a.x[read_pixel(i) * C + c] - mu1[i]) * rs1[i];
        sb += g;
      }
      pln[c] += sw;
      pln[C + c] += sb;
    }
    __syncthreads();
    for (int i = warp; i < 64; i += kThreads / 32) {
      const long long pix = read_pixel(i) * C;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float g = R0[i * ldx + c] * g1[c];
        s1 += g;
        s2 += g * (a.x[pix + c] - mu1[i]) * rs1[i];
      }
      const float m1 = group_sum(s1, 32) / C, m2 = group_sum(s2, 32) / C;
      for (int c = lane; c < C; c += 32) {
        const float xh = (a.x[pix + c] - mu1[i]) * rs1[i];
        a.dx[pix + c] = R1[i * ldx + c] + rs1[i] * (R0[i * ldx + c] * g1[c] - m1 - xh * m2);
      }
    }
  }
}

struct WgradArgs {
  const float* ops;
  float* part_w;
  long long T;
  int C, NH, HDP, hidden, ts;
};

__global__ void __launch_bounds__(kThreads) swin_wgrad_f32_kernel(WgradArgs a) {
  __shared__ __align__(16) float As[2 * kKT * kWR];
  __shared__ __align__(16) float Bs[2 * kKT * kWC];
  const Products pr(a.T, a.C, a.NH, a.HDP, a.hidden);
  int tile = blockIdx.x, p = 0;
  while (tile >= pr.tiles(p)) tile -= pr.tiles(p++);
  const int kin = pr.kin[p], nout = pr.nout[p];
  const int nct = (nout + kWC - 1) / kWC;
  const int r0 = (tile / nct) * kWR, c0 = (tile % nct) * kWC;
  const long long t0 = (long long)blockIdx.y * a.ts;
  const long long t1 = t0 + a.ts < a.T ? t0 + a.ts : a.T;
  const int K = t1 > t0 ? (int)(t1 - t0) : 0;
  const int ones = kin - r0 < kWR ? kin - r0 : -1;
  const Strided A(a.ops + pr.a_off[p] + t0 * kin + r0, kin, 1,
                  kin - r0 < kWR ? kin - r0 : kWR, ones);
  const Strided G(a.ops + pr.g_off[p] + t0 * nout + c0, nout, 1,
                  nout - c0 < kWC ? nout - c0 : kWC);
  float* dst = a.part_w + blockIdx.y * pr.total + pr.d_off[p];
  block_gemm<kWC>(A, G, K, kWR, kWC, As, Bs, [&](int rr, int nn, const float(&v)[4][4]) {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + rr + i, c = c0 + nn + j;
        if (r <= kin && c < nout) dst[(long long)r * nout + c] = v[i][j];
      }
  });
}

__global__ void sum_parts_kernel(const float* part, int nparts, long long n, float* out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += part[p * n + e];
    out[e] = s;
  }
}

cudaError_t sum_parts(const float* part, int nparts, long long n, float* out, cudaStream_t st) {
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  sum_parts_kernel<<<blocks, 256, 0, st>>>(part, nparts, n, out);
  return cudaGetLastError();
}

}  // namespace

// x, dy (B, H, W, C) f32; the forward's pack; ops (op_floats a token), the
// partials part_bias (grid, NH, 64, 64) and part_ln (grid, 4, C) zeroed by
// the caller, part_w (splits, total); outputs dx, dw (the four products' D
// back to back, each (Kin + 1, Nout)), dln (4, C), dbias (NH, 64, 64).
extern "C" int kair_swin_block_2d_bwd_f32(
    const void* x, const void* dy, const void* wqkv, const void* bqkv, const void* wp,
    const void* bp, const void* ln, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* relbias, const void* mask, void* ops, void* part_bias,
    void* part_ln, void* part_w, void* dx, void* dw, void* dln, void* dbias, int B, int H, int W,
    int C, int NH, int HDP, int hidden, int phase, int grid, int splits, float scale,
    void* stream) {
  const BwdF32Plan pl(C, NH, HDP);
  if (pl.smem() > kSmemLimit || H % 8 || W % 8 || C % 4 || HDP % 4 || hidden % 4 || grid < 1 ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(swin_bwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem());
  if (e != cudaSuccess) return (int)e;
  const auto F = [](const void* p) { return static_cast<const float*>(p); };
  BwdArgs a{F(x),        F(dy),        F(wqkv),   F(bqkv),
            F(wp),       F(bp),        F(ln),     F(w1),
            F(b1),       F(w2),        F(b2),     F(relbias),
            F(mask),     static_cast<float*>(ops), static_cast<float*>(part_bias),
            static_cast<float*>(part_ln), static_cast<float*>(dx), B,
            H,           W,            C,         NH,
            HDP,         hidden,       phase,     scale};
  swin_bwd_f32_kernel<<<grid, kThreads, pl.smem(), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long T = (long long)B * H * W;
  const Products pr(T, C, NH, HDP, hidden);
  int tiles = 0;
  for (int p = 0; p < 4; ++p) tiles += pr.tiles(p);
  WgradArgs w{static_cast<const float*>(ops), static_cast<float*>(part_w), T, C, NH, HDP, hidden,
              (int)((T + splits - 1) / splits)};
  swin_wgrad_f32_kernel<<<dim3(tiles, splits), kThreads, 0, st>>>(w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = sum_parts(static_cast<const float*>(part_w), splits, pr.total,
                     static_cast<float*>(dw), st)) != cudaSuccess)
    return (int)e;
  if ((e = sum_parts(static_cast<const float*>(part_bias), grid, (long long)NH * 4096,
                     static_cast<float*>(dbias), st)) != cudaSuccess)
    return (int)e;
  return (int)sum_parts(static_cast<const float*>(part_ln), grid, 4LL * C,
                        static_cast<float*>(dln), st);
}

// dst (host int[4]): pass-1 shared bytes, operand floats a token, floats of
// the four products' D, pass-2 tiles. Returns the shared bytes.
extern "C" int kair_swin_bwd_f32_plan(int C, int NH, int HDP, int hidden, int* dst) {
  const BwdF32Plan pl(C, NH, HDP);
  const Products pr(1, C, NH, HDP, hidden);
  int tiles = 0;
  for (int p = 0; p < 4; ++p) tiles += pr.tiles(p);
  dst[0] = pl.smem();
  dst[1] = op_floats(C, NH, HDP, hidden);
  dst[2] = (int)pr.total;
  dst[3] = tiles;
  return pl.smem();
}
