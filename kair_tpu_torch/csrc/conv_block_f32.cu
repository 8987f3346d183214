// Fused 3x3 conv + bias + residual with the cyclic un-roll, in f32 on the
// CUDA cores: the entry kair_conv3x3_residual_f32.
//
// Replaces, for f32 inputs, kair_tpu/ops/pallas/conv_block.py ::
// conv3x3_residual (TPU body _kernel :49, pl.pallas_call :94), whose body
// computes in its input's dtype: the SwinIR RSTB tail and conv_after_body,
//
//   out = conv3x3_SAME(roll(y, (phase, phase))) + bias + res      (NHWC)
//
// with the roll folded into the read: tap (ky, kx) of output pixel (py, px)
// reads y[(py + ky - 1 - phase) mod H, (px + kx - 1 - phase) mod W] where
// py + ky - 1 and px + kx - 1 lie inside the map, and 0 outside (SAME
// padding of the rolled map).
//
// Bound on the H100: at SwinIR-M width (C=180) a pixel takes 583,200 FLOP
// against 2,160 bytes of f32 in and out: bound by f32 operations, 2.28 ms at
// 67 TFLOP/s for B=16 of 128x128.
//
// Design: an implicit GEMM, simple first. One block of 256 threads takes an
// 8x8 tile of output pixels (the 64 rows) and every output channel;
// K = 9 C runs tap-major, k = tap * C + ci, staged 16 at a time through
// shared memory (kair::f32k::block_gemm, simt_f32.cuh), the tap's shifted
// and wrapped pixel computed as the A operand is staged; the weights are
// packed once as (9, C_in, C_out) (ops/kernels/conv_block.py ::
// pack_conv3x3_f32) so a staged row of B is one coalesced read. Shared
// memory: the staging, two stages of 16 x 64 and 16 x min(C, 256) floats.
#include <cuda_runtime.h>

#include "simt_f32.cuh"

using namespace kair::f32k;

namespace {

constexpr int kNB = 256;    // output channels a pass over K covers

struct ConvArgs {
  const float *y, *res, *w, *bias;
  float* out;
  int B, H, W, C, phase;
};

// A(k, r) of an 8x8 tile: k = tap * C + ci, r = the tile's pixel.
struct TapLoader {
  const float* y;
  int H, W, C, phase, b, py0, px0;
  bool kfast;
  __device__ float operator()(int k, int r) const {
    const int tap = k / C, ci = k - tap * C;
    const int py = py0 + r / 8 + tap / 3 - 1, px = px0 + r % 8 + tap % 3 - 1;
    if (py < 0 || py >= H || px < 0 || px >= W) return 0.f;
    int sy = (py - phase) % H, sx = (px - phase) % W;
    sy += sy < 0 ? H : 0;
    sx += sx < 0 ? W : 0;
    return y[(((long long)b * H + sy) * W + sx) * C + ci];
  }
};

__global__ void __launch_bounds__(kThreads) conv3x3_f32_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + 2 * kKT * 64;
  const int C = a.C, b = blockIdx.z, py0 = blockIdx.y * 8, px0 = blockIdx.x * 8;
  const TapLoader A{a.y, a.H, a.W, C, a.phase, b, py0, px0, true};
  block_gemm<kNB>(A, Strided(a.w, C, 1, C), 9 * C, 64, C, As, Bs,
             [&](int r0, int n0, const float(&v)[4][4]) {
               for (int i = 0; i < 4; ++i) {
                 const int py = py0 + (r0 + i) / 8, px = px0 + (r0 + i) % 8;
                 if (py >= a.H || px >= a.W) continue;
                 const long long o = (((long long)b * a.H + py) * a.W + px) * C + n0;
                 for (int j = 0; j < 4; ++j) a.out[o + j] = v[i][j] + a.bias[n0 + j] + a.res[o + j];
               }
             });
}

int conv_smem(int C) { return 4 * stage_floats(64, C, kNB); }

}  // namespace

// y, res, out (B, H, W, C) f32; w the (9, C, C) pack; bias (C). Returns a
// cudaError_t.
extern "C" int kair_conv3x3_residual_f32(const void* y, const void* res, const void* w,
                                         const void* bias, void* out, int B, int H, int W, int C,
                                         int phase, void* stream) {
  if (C % 4 || conv_smem(C) > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, conv_smem(C));
  if (e != cudaSuccess) return (int)e;
  ConvArgs a{static_cast<const float*>(y),    static_cast<const float*>(res),
             static_cast<const float*>(w),    static_cast<const float*>(bias),
             static_cast<float*>(out),        B,
             H,                               W,
             C,                               phase};
  conv3x3_f32_kernel<<<dim3((W + 7) / 8, (H + 7) / 8, B), kThreads, conv_smem(C),
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int kair_conv3x3_f32_shared_bytes(int C) { return conv_smem(C); }
