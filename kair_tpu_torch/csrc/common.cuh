// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// Matrix products use the tensor cores through WMMA (<mma.h>): bf16 operands,
// f32 accumulation, 16x16x16 tiles. Only CUDA toolkit headers are included,
// so the whole library builds with one plain nvcc call in seconds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace kair {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kStage = 256;             // f32 staging floats per warp (one tile)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

static __host__ __device__ __forceinline__ int round16(int v) { return (v + 15) / 16 * 16; }
static __host__ __device__ __forceinline__ int align128(int v) { return (v + 127) / 128 * 128; }
static __host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
static __device__ __forceinline__ int wrap(int v, int n) { v %= n; return v < 0 ? v + n : v; }

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Store one accumulator tile into the warp's 16x16 f32 staging area and hand
// each element to epi(row, col, value); lane l takes row l/2, columns
// 8*(l%2) .. 8*(l%2)+7. WMMA's register layout is opaque, so every epilogue
// (bias, residual, GELU, bf16 store) goes through this.
template <class Epi>
__device__ __forceinline__ void drain_tile(const FragC& acc, float* stage,
                                           int row0, int col0, Epi& epi) {
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) epi(row0 + r, col0 + c0 + i, stage[r * 16 + c0 + i]);
  __syncwarp();
}

// out[64, 16*n_tiles] = A[64, 16*k_tiles] @ B, then epi per element.
// A: bf16 in shared memory, row-major, leading dimension lda.
// B: bf16 in global memory (L2-resident weights), row-major, ldb.
// With NW warps in the block, warp w owns column tiles w, w+NW, ... and all
// four 16-row tiles of each, so every B tile is read from L2 once per block.
template <int NW, class Epi>
__device__ void gemm_m64(const bf16* A, int lda, const bf16* __restrict__ B,
                         int ldb, int k_tiles, int n_tiles, float* stage, Epi& epi) {
  const int warp = threadIdx.x >> 5;
  for (int n = warp; n < n_tiles; n += NW) {
    FragC acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int k = 0; k < k_tiles; ++k) {
      FragB b;
      wmma::load_matrix_sync(b, B + (size_t)k * 16 * ldb + n * 16, ldb);
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


// Two products of one A against B1 and B2 (the GEGLU MLP's fc11 and fc12):
// epi(row, col, a1, a2) gets both sums of an element at once. stage holds
// two f32 tiles per warp (2 * kStage floats).
template <int NW, class Epi2>
__device__ void gemm_m64_dual(const bf16* A, int lda, const bf16* __restrict__ B1,
                              const bf16* __restrict__ B2, int ldb, int k_tiles,
                              int n_tiles, float* stage, Epi2& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = warp; n < n_tiles; n += NW) {
    FragC acc1[4], acc2[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wmma::fill_fragment(acc1[m], 0.0f);
      wmma::fill_fragment(acc2[m], 0.0f);
    }
    for (int k = 0; k < k_tiles; ++k) {
      FragB b1, b2;
      wmma::load_matrix_sync(b1, B1 + (size_t)k * 16 * ldb + n * 16, ldb);
      wmma::load_matrix_sync(b2, B2 + (size_t)k * 16 * ldb + n * 16, ldb);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        FragA a;
        wmma::load_matrix_sync(a, A + m * 16 * lda + k * 16, lda);
        wmma::mma_sync(acc1[m], a, b1, acc1[m]);
        wmma::mma_sync(acc2[m], a, b2, acc2[m]);
      }
    }
    const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wmma::store_matrix_sync(stage, acc1[m], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(stage + kStage, acc2[m], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i)
        epi(m * 16 + r, n * 16 + c0 + i, stage[r * 16 + c0 + i],
            stage[kStage + r * 16 + c0 + i]);
      __syncwarp();
    }
  }
}

}  // namespace kair
