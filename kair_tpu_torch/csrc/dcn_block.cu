// Modulated deformable 3x3 convolution (DCNv2), inference, bf16 (sm_90a).
//
// Replaces kair_tpu/ops/pallas/dcn_block.py :: dcn_fused (the
// pl.pallas_call of _dcn_fused_fwd, body _dcn_kernel), VRT's flow-guided
// alignment (models/vrt.py DCNv2PackFlowGuided):
//
//   out[n, i, j, o] = bias[o] + sum_{g, k, c} w[o, g*cg + c, k] *
//       mask[n, i, j, g, k] * bilinear(x[n, :, :, g*cg + c],
//                                      i - 1 + k/3 + off[n, i, j, g, k, 0],
//                                      j - 1 + k%3 + off[n, i, j, g, k, 1])
//
// with torchvision's zeros padding (a tap's corners outside the frame read
// 0) and the JAX package's offset layout (n, ho, wo, dg, K, 2), y first.
//
// Bound on the H100: at VRT-001's stage 1 (64x64, 120 -> 120 channels, 12
// groups) one call does 1.09 GFLOP and moves ~7.5 MB (x and out in bf16,
// the f32 offsets and mask): about 1.1 us of tensor-core time or 2.2 us of
// memory, so the bytes bound it; in practice a call of this size is bound
// by its latency. What the design does about it: the sampled columns (the
// im2col tile) exist only in shared memory, 32 output pixels x 256
// columns at a time, and go straight into the tensor-core
// product with the packed weight; the sum over groups and taps stays in each
// warp's accumulators, so it needs no atomics and is deterministic. The
// sampling is a direct gather from device memory (L1/L2): the TPU kernel's
// 2-hot matmuls, MXU_MAX_HW and lane padding are TPU workarounds with no
// counterpart here. Sums are f32 (the TPU kernel's sample matmul sums in the
// input type).
//
// Layouts (ops/kernels/dcn_block.py::pack_dcn_weight): w [KP][CP] bf16, row
// (g*9 + k)*cg + c, column o, zero-padded to KP = round16(9*Cin) and
// CP = round16(Cout); x, out bf16 NHWC; off, mask, bias f32.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;                    // output pixels per block
constexpr int kChunk = 256;                  // columns sampled per round
constexpr int kLC = kChunk + 8;              // column tile row (bf16)
constexpr int kMaxNT = 2;                    // output column tiles per warp
constexpr int kMaxCout = kWarps * kMaxNT * 16;

struct DcnArgs {
  const bf16* x;
  const float* off;
  const float* mask;
  const bf16* w;
  const float* bias;
  bf16* out;
  int N, H, W, Cin, Cout, DG;
};

int dcn_shared_bytes() { return align128(kRows * kLC * 2) + kWarps * kStage * 4; }

__device__ __forceinline__ float sample(const bf16* x, int H, int W, int Cin, float fy,
                                        float fx) {
  if (!(fy > -1.f && fy < (float)H && fx > -1.f && fx < (float)W)) return 0.f;
  const float y0f = floorf(fy), x0f = floorf(fx);
  const int y0 = (int)y0f, x0 = (int)x0f;
  const float ly = fy - y0f, lx = fx - x0f;
  float v = 0.f;
  if (y0 >= 0) {
    if (x0 >= 0) v += (1.f - ly) * (1.f - lx) * __bfloat162float(x[((size_t)y0 * W + x0) * Cin]);
    if (x0 + 1 < W) v += (1.f - ly) * lx * __bfloat162float(x[((size_t)y0 * W + x0 + 1) * Cin]);
  }
  if (y0 + 1 < H) {
    if (x0 >= 0) v += ly * (1.f - lx) * __bfloat162float(x[((size_t)(y0 + 1) * W + x0) * Cin]);
    if (x0 + 1 < W) v += ly * lx * __bfloat162float(x[((size_t)(y0 + 1) * W + x0 + 1) * Cin]);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) dcn_kernel(DcnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* cols = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  float* stage = reinterpret_cast<float*>(smem + align128(kRows * kLC * 2)) + warp * kStage;
  const int HW = a.H * a.W, tiles = (HW + kRows - 1) / kRows;
  const int n = blockIdx.x / tiles, p0 = (blockIdx.x % tiles) * kRows;
  const int cg = a.Cin / a.DG, KC = 9 * a.Cin, KP = round16(KC), CP = round16(a.Cout);
  const int NT = CP / 16;
  const bf16* xn = a.x + (size_t)n * HW * a.Cin;

  FragC acc[kMaxNT][2];
#pragma unroll
  for (int t = 0; t < kMaxNT; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m) wmma::fill_fragment(acc[t][m], 0.f);

  for (int k0 = 0; k0 < KP; k0 += kChunk) {
    const int kc = min(kChunk, KP - k0);
    // sample: consecutive threads take consecutive channels of one tap
    for (int i = tid; i < kRows * kc; i += kThreads) {
      const int r = i / kc, col = k0 + i - r * kc, pix = p0 + r;
      float v = 0.f;
      if (col < KC && pix < HW) {
        const int g = col / (9 * cg), rem = col - g * 9 * cg;
        const int k = rem / cg, c = rem - k * cg;
        const int py = pix / a.W, px = pix - py * a.W;
        const size_t gk = (((size_t)n * HW + pix) * a.DG + g) * 9 + k;
        const float fy = (float)(py - 1 + k / 3) + a.off[2 * gk];
        const float fx = (float)(px - 1 + k % 3) + a.off[2 * gk + 1];
        v = a.mask[gk] * sample(xn + g * cg + c, a.H, a.W, a.Cin, fy, fx);
      }
      cols[r * kLC + (col - k0)] = __float2bfloat16(v);
    }
    __syncthreads();
    for (int kt = 0; kt < kc / 16; ++kt) {
#pragma unroll
      for (int t = 0; t < kMaxNT; ++t) {
        const int nt = warp + t * kWarps;
        if (nt >= NT) break;
        FragB b;
        wmma::load_matrix_sync(b, a.w + (size_t)(k0 + kt * 16) * CP + nt * 16, CP);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          FragA fa;
          wmma::load_matrix_sync(fa, cols + m * 16 * kLC + kt * 16, kLC);
          wmma::mma_sync(acc[t][m], fa, b, acc[t][m]);
        }
      }
    }
    __syncthreads();
  }
  bf16* out = a.out + (size_t)n * HW * a.Cout;
  const float* bias = a.bias;
  const int Cout = a.Cout;
  auto epi = [&](int r, int c, float v) {
    if (p0 + r < HW && c < Cout)
      out[(size_t)(p0 + r) * Cout + c] = __float2bfloat16(v + bias[c]);
  };
#pragma unroll
  for (int t = 0; t < kMaxNT; ++t) {
    const int nt = warp + t * kWarps;
    if (nt >= NT) break;
#pragma unroll
    for (int m = 0; m < 2; ++m) drain_tile(acc[t][m], stage, m * 16, nt * 16, epi);
  }
}

}  // namespace

extern "C" int kair_dcn_shared_bytes() { return dcn_shared_bytes(); }

// x [N][H][W][Cin] bf16, off [N][H][W][DG][9][2] f32, mask [N][H][W][DG][9]
// f32, w [KP][CP] bf16, bias [Cout] f32, out [N][H][W][Cout] bf16;
// N, H, W, Cin, Cout, DG, stream
extern "C" int kair_dcn(const void* x, const void* off, const void* mask, const void* w,
                        const void* bias, void* out, int N, int H, int W, int Cin, int Cout,
                        int DG, void* stream) {
  if (DG < 1 || Cin % DG || Cout < 1 || Cout > kMaxCout) return (int)cudaErrorInvalidValue;
  DcnArgs a;
  a.x = static_cast<const bf16*>(x);
  a.off = static_cast<const float*>(off);
  a.mask = static_cast<const float*>(mask);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.N = N; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout; a.DG = DG;
  const int smem = dcn_shared_bytes();
  cudaError_t e = cudaFuncSetAttribute(dcn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)N * ((H * W + kRows - 1) / kRows);
  dcn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
