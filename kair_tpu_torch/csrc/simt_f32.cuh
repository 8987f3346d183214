// f32 building blocks of the port's f32 kernels (swin_block_f32.cu,
// conv_block_f32.cu): a block-wide matrix product on the CUDA cores (FFMA,
// f32 accumulation) over operands staged through shared memory, and the
// row reductions around it. No tensor cores: these kernels compute what
// their TPU counterparts compute on f32 inputs, in f32 throughout.
//
// The product. out(r, n) = sum over k < K of A(k, r) * B(k, n), for r < NR
// and n < NN (a multiple of 4). Each operand is a loader: an object whose
// operator()(k, r) gives the element (0 past the operand's extent) and
// whose kfast says which index runs along memory (the staging walks that
// one fastest, so global reads coalesce). K is staged kKT rows at a time
// into two stages in shared memory, the next rows' loads in flight in
// registers while the current ones are multiplied; a thread carries up to
// NB / 64 4x4 output tiles through K, 16 FFMA per tile per k against one
// 16-byte shared load of A (shared by its tiles) and one of B; the columns
// go in passes of NB. The epilogue gets each finished tile,
// acc[a][b] = out(r0 + a, n0 + b).
//
// A loader may read shared or global memory through a generic pointer;
// data written by the same block before a __syncthreads() is read back
// coherently (plain loads, never the read-only path).
#pragma once

#include <cuda_runtime.h>

namespace kair {
namespace f32k {

constexpr int kThreads = 256;   // 8 warps
constexpr int kKT = 16;         // K rows staged at a time

// Shared floats of block_gemm<NB>'s staging: two stages of A (kKT x nr)
// and of B (kKT x the widest pass, nnmax columns up to NB).
static __host__ __device__ __forceinline__ int stage_floats(int nr, int nnmax, int nb) {
  return 2 * kKT * nr + 2 * kKT * (nnmax < nb ? nnmax : nb);
}

// A(k, r) = p[k * sk + r * sr] for r < n; row `ones` reads 1 (a bias row
// of ones), every other element past n reads 0.
struct Strided {
  const float* p;
  int sk, sr, n, ones;
  bool kfast;
  __device__ Strided(const float* p_, int sk_, int sr_, int n_, int ones_ = -1)
      : p(p_), sk(sk_), sr(sr_), n(n_), ones(ones_), kfast(sk_ == 1 && sr_ != 1) {}
  __device__ __forceinline__ float operator()(int k, int r) const {
    if (r == ones) return 1.f;
    return r < n ? p[(long long)k * sk + (long long)r * sr] : 0.f;
  }
};

// A thread's share of a kKT x N tile (N <= W, a multiple of 64): W / 16
// elements. Along k (kfast): kk = tid % kKT, r = tid / kKT + 16 i; along
// r: r = tid % 64 + 64 i, kk = tid / 64 + 4 j, element i * 4 + j. Either
// walk reads memory contiguously across neighbouring threads.
template <int W, class L>
__device__ __forceinline__ void fetch(const L& ld, int k0, int K, int c0, int N,
                                      float (&v)[W / 16]) {
  const int t = threadIdx.x;
  if (ld.kfast) {
    const int kk = t % kKT;
    const bool in_k = k0 + kk < K;
#pragma unroll
    for (int i = 0; i < W / 16; ++i) {
      const int r = t / kKT + 16 * i;
      v[i] = in_k && r < N ? ld(k0 + kk, c0 + r) : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W / 64; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = t % 64 + 64 * i, kk = t / 64 + 4 * j;
        v[i * 4 + j] = k0 + kk < K && r < N ? ld(k0 + kk, c0 + r) : 0.f;
      }
  }
}

template <int W, class L>
__device__ __forceinline__ void put(const L& ld, const float (&v)[W / 16], int N, float* dst) {
  const int t = threadIdx.x;
  if (ld.kfast) {
    const int kk = t % kKT;
#pragma unroll
    for (int i = 0; i < W / 16; ++i) {
      const int r = t / kKT + 16 * i;
      if (r < N) dst[kk * N + r] = v[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < W / 64; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = t % 64 + 64 * i, kk = t / 64 + 4 * j;
        if (r < N) dst[kk * N + r] = v[i * 4 + j];
      }
  }
}

// out(r, n) = sum over k < K of A(k, r) * B(k, n) for r < NR (16, 32 or 64)
// and n < NN (a multiple of 4). The columns go in passes of NB (128 or 256);
// in each pass a thread carries up to NB / 64 4x4 tiles (row group
// tid % (NR / 4), column groups tid / (NR / 4) + p (kThreads / (NR / 4)))
// through K, which is staged kKT rows at a time in two stages (As: 2 kKT NR
// floats, Bs: 2 kKT min(NN, NB)): the next rows' loads are in flight in
// registers while the current ones are multiplied, one barrier a step.
// Starts with a barrier (the operands' writers are done) and ends with one
// (the epilogue's writes are visible, As / Bs are free). The epilogue gets
// each finished tile, acc[a][b] = out(r0 + a, n0 + b), and must not write
// an operand of the same product.
template <int NB, class LA, class LB, class Epi>
__device__ void block_gemm(const LA& A, const LB& B, int K, int NR, int NN, float* As,
                           float* Bs, Epi epi) {
  constexpr int P = NB / 64;
  const int rgn = NR / 4, cstep = kThreads / rgn;
  const int r0 = (threadIdx.x % rgn) * 4, cg0 = threadIdx.x / rgn;
  for (int n0 = 0; n0 < NN; n0 += NB) {
    const int nb = NN - n0 < NB ? NN - n0 : NB;
    float acc[P][4][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[p][a][b] = 0.f;
    float ra[64 / 16], rb[NB / 16];
    __syncthreads();
    fetch<64>(A, 0, K, 0, NR, ra);
    fetch<NB>(B, 0, K, n0, nb, rb);
    put<64>(A, ra, NR, As);
    put<NB>(B, rb, nb, Bs);
    __syncthreads();
    for (int k0 = 0, s = 0; k0 < K; k0 += kKT, s ^= 1) {
      const bool more = k0 + kKT < K;
      if (more) {
        fetch<64>(A, k0 + kKT, K, 0, NR, ra);
        fetch<NB>(B, k0 + kKT, K, n0, nb, rb);
      }
      const float* as = As + s * kKT * NR;
      const float* bs = Bs + s * kKT * nb;
#pragma unroll 4
      for (int kk = 0; kk < kKT; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(as + kk * NR + r0);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int c = (cg0 + p * cstep) * 4;
          if (c >= nb) continue;
          const float4 b = *reinterpret_cast<const float4*>(bs + kk * nb + c);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[p][i][j] = fmaf(av[i], bv[j], acc[p][i][j]);
        }
      }
      if (more) {
        put<64>(A, ra, NR, As + (s ^ 1) * kKT * NR);
        put<NB>(B, rb, nb, Bs + (s ^ 1) * kKT * nb);
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = (cg0 + p * cstep) * 4;
      if (c < nb) epi(r0, n0 + c, acc[p]);
    }
  }
  __syncthreads();
}

// Sum over the lanes of an aligned group of `width` lanes (a power of two).
static __device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ float group_max(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Exact GELU, x * Phi(x), and its derivative Phi(x) + x * phi(x).
static __device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

static __device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * expf(-0.5f * x * x);
}

}  // namespace f32k
}  // namespace kair
