// Bilinear sampling with zeros padding, forward and backward (sm_90a).
//
// Replaces kair_tpu/ops/pallas/bilin_mm.py :: bilinear_sample_mm, both of its
// pl.pallas_call sites: the forward (_kernel, :197) and the custom-VJP
// backward (_bwd_kernel, :312). It is the deform_impl "mxu" sampler of VRT's
// DCNv2 (ops/warp.py) and RVRT's guided deformable attention
// (ops/deform_attn.py):
//
//   out[g, r, c] = sum over the four corners (y, x) of (fy[g, r], fx[g, r])
//                  of hat(y - fy) * hat(x - fx) * feat[g, y, x, c]
//
// with hat(d) = max(1 - |d|, 0) and a corner outside the H x W frame reading
// 0. The backward gives
//
//   dfeat[g, y, x, c] = sum_r hat(y - fy) hat(x - fx) dout[g, r, c]
//   dfy[g, r] = sum_c dout[g, r, c] sum_(y, x) Sy(y) hat(x - fx) feat[g, y, x, c]
//   dfx[g, r]  likewise with Sx(x) hat(y - fy)
//
// where Sy(y) = sign(y - fy) * ceil(hat(y - fy)) is the Pallas kernel's
// derivative of the hat (bilin_mm.py:234-249): -1 at floor(fy) and +1 at
// floor(fy) + 1 when fy has a fraction, and 0 for both when fy is an exact
// integer (the symmetric subgradient; the floor form's gather would give
// feat[y0 + 1] - feat[y0] there).
//
// Bound on the H100: almost no arithmetic (about 8 FLOP per output element),
// so the bytes bound it. At VRT-001's stage-1 call at batch 8 (G = 96 slabs
// of 64x64x10, R = 36,864 rows) the forward moves 7.9 MB of bf16 feat, 28 MB
// of f32 coordinates and 71 MB of bf16 samples: about 32 us at 3.35 TB/s.
// The TPU kernel's 2-hot matmuls, hat-weight matrices, lane padding
// (_pad_cs), MXU_MAX_HW size gate and row tiles are TPU gather workarounds;
// on Hopper the sample is a direct gather through L1/L2, for frames of any
// size. Design: kLanes = 8 threads share one row; each computes the row's
// four corner weights once and takes the channels c = lane, lane + 8, ...,
// so neighbouring threads read neighbouring channels of a corner pixel.
// The backward adds each corner's share of dout into an f32 dfeat with
// atomicAdd (the order of that sum varies from run to run: the f32 sum of a
// few dozen terms moves in its last bits), and sums dfy and dfx over the
// row's channels in f32 with an xor-shuffle over the 8 lanes, so they are
// deterministic. Coordinates are f32; feat, out and dout are f32 or bf16.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kLanes = 8;                    // threads per row
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / kLanes;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// The four corners of (fy, fx) in an H x W frame: pixel index and weight of
// (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1); a corner outside the frame
// gets weight 0, pixel 0 and in = false. ty, tx are the fractions.
struct Corners {
  int p[4];
  float w[4];
  bool in[4];
  float ty, tx;
};

__device__ __forceinline__ Corners corners(float fy, float fx, int H, int W) {
  Corners k;
  const float y0f = floorf(fy), x0f = floorf(fx);
  k.ty = fy - y0f;
  k.tx = fx - x0f;
  // clamp before the conversion: a far-away tap must not overflow an int
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  const float wy[2] = {1.f - k.ty, k.ty}, wx[2] = {1.f - k.tx, k.tx};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool v = y0 + i >= 0 && y0 + i < H && x0 + j >= 0 && x0 + j < W;
      k.in[2 * i + j] = v;
      k.p[2 * i + j] = v ? (y0 + i) * W + x0 + j : 0;
      k.w[2 * i + j] = v ? wy[i] * wx[j] : 0.f;
    }
  return k;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
bilin_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ fy,
                 const float* __restrict__ fx, T* __restrict__ out, int H, int W, int Cs,
                 long long R, long long rows) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (row >= rows) return;
  const long long g = row / R;
  const Corners k = corners(fy[row], fx[row], H, W);
  const T* f = feat + g * H * W * Cs;
  T* o = out + row * Cs;
  for (int c = lane; c < Cs; c += kLanes) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) v += k.w[i] * to_f(f[(long long)k.p[i] * Cs + c]);
    o[c] = from_f<T>(v);
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
bilin_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ fy,
                 const float* __restrict__ fx, const T* __restrict__ dout,
                 float* __restrict__ dfeat, float* __restrict__ dfy, float* __restrict__ dfx,
                 int H, int W, int Cs, long long R, long long rows) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float sy = 0.f, sx = 0.f;
  // no early return: every lane of the warp takes part in the shuffles
  if (row < rows) {
    const long long g = row / R;
    const Corners k = corners(fy[row], fx[row], H, W);
    // the hat's derivative: 0 on both rows (columns) at an exact integer
    const float dy0 = k.ty > 0.f ? -1.f : 0.f, dy1 = k.ty > 0.f ? 1.f : 0.f;
    const float dx0 = k.tx > 0.f ? -1.f : 0.f, dx1 = k.tx > 0.f ? 1.f : 0.f;
    const float wy0 = 1.f - k.ty, wy1 = k.ty, wx0 = 1.f - k.tx, wx1 = k.tx;
    const T* f = feat + g * H * W * Cs;
    float* df = dfeat + g * H * W * Cs;
    const T* d = dout + row * Cs;
    for (int c = lane; c < Cs; c += kLanes) {
      const float go = to_f(d[c]);
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = k.in[i] ? to_f(f[(long long)k.p[i] * Cs + c]) : 0.f;
        if (k.w[i] != 0.f) atomicAdd(df + (long long)k.p[i] * Cs + c, k.w[i] * go);
      }
      sy += go * (dy0 * (wx0 * v[0] + wx1 * v[1]) + dy1 * (wx0 * v[2] + wx1 * v[3]));
      sx += go * (dx0 * (wy0 * v[0] + wy1 * v[2]) + dx1 * (wy0 * v[1] + wy1 * v[3]));
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
  }
  if (row < rows && lane == 0) {
    dfy[row] = sy;
    dfx[row] = sx;
  }
}

unsigned grid_of(long long rows) {
  return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// feat [G][H][W][Cs], fy, fx [G][R] f32, out [G][R][Cs]; feat and out f32
// (bf16 = 0) or bf16 (bf16 = 1); G, H, W, Cs, R, bf16, stream
extern "C" int kair_bilin_fwd(const void* feat, const void* fy, const void* fx, void* out,
                              int G, int H, int W, int Cs, int R, int bf16_io,
                              void* stream) {
  if (G < 0 || H < 1 || W < 1 || Cs < 1 || R < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)G * R;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(fy);
  const float* x = static_cast<const float*>(fx);
  if (bf16_io)
    bilin_fwd_kernel<bf16><<<grid_of(rows), kThreads, 0, s>>>(
        static_cast<const bf16*>(feat), y, x, static_cast<bf16*>(out), H, W, Cs, R, rows);
  else
    bilin_fwd_kernel<float><<<grid_of(rows), kThreads, 0, s>>>(
        static_cast<const float*>(feat), y, x, static_cast<float*>(out), H, W, Cs, R, rows);
  return (int)cudaGetLastError();
}

// feat [G][H][W][Cs], fy, fx [G][R] f32, dout [G][R][Cs] (feat's type);
// dfeat [G][H][W][Cs] f32, zeroed by the caller; dfy, dfx [G][R] f32;
// G, H, W, Cs, R, bf16, stream
extern "C" int kair_bilin_bwd(const void* feat, const void* fy, const void* fx,
                              const void* dout, void* dfeat, void* dfy, void* dfx, int G,
                              int H, int W, int Cs, int R, int bf16_io, void* stream) {
  if (G < 0 || H < 1 || W < 1 || Cs < 1 || R < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)G * R;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(fy);
  const float* x = static_cast<const float*>(fx);
  float* df = static_cast<float*>(dfeat);
  float* dy = static_cast<float*>(dfy);
  float* dx = static_cast<float*>(dfx);
  if (bf16_io)
    bilin_bwd_kernel<bf16><<<grid_of(rows), kThreads, 0, s>>>(
        static_cast<const bf16*>(feat), y, x, static_cast<const bf16*>(dout), df, dy, dx,
        H, W, Cs, R, rows);
  else
    bilin_bwd_kernel<float><<<grid_of(rows), kThreads, 0, s>>>(
        static_cast<const float*>(feat), y, x, static_cast<const float*>(dout), df, dy, dx,
        H, W, Cs, R, rows);
  return (int)cudaGetLastError();
}
