// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// Matrix products use the tensor cores through WMMA (<mma.h>): bf16 operands,
// f32 accumulation, 16x16x16 tiles; or, at the end of this file, through
// Hopper's warpgroup products (wgmma) fed by mbarrier-tracked asynchronous
// copies. Only CUDA toolkit headers are included, so the whole library
// builds with one plain nvcc call in seconds.
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

// ---------------------------------------------------------------------------
// Hopper: mbarriers, asynchronous copies, ldmatrix and wgmma (inline PTX)
// ---------------------------------------------------------------------------

static __device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory that completes a phase after `count` arrivals
// (and, with expect_tx, the bytes it was told to expect).
static __device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (bulk copies).
static __device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

static __device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of copies.
static __device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                             unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed. A fresh
// barrier counts the phase before its first (parity 1) as completed, so a
// producer's first wait on an empty slot, with parity 1, passes at once.
// A wait that lasts 2^34 clock cycles (about 10 s) traps: a protocol fault
// ends the launch with an error instead of hanging the card.
static __device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 == 0)
      t0 = t;
    else if (t - t0 > (1LL << 34))
      __trap();
  }
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory; completion counts against the barrier's
// expected transaction bytes.
static __device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                                                     unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Asynchronous 8- or 4-byte copy global -> shared; src_bytes 0 writes zeros
// (the source is not read).
static __device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

static __device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Asynchronous 16-byte copy global -> shared, both addresses 16-byte aligned.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Closes this thread's group of cp.async copies; cp_async_wait_all waits for
// all of its groups.
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One arrival on the barrier once all of this thread's earlier cp.async
// copies have landed (counts as one of the barrier's arrivals).
static __device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. With lanes 0-15 on rows 0-15 at column k and lanes
// 16-31 on the same rows at column k + 8, r[0..3] is the A fragment of a
// 16x16 tile for mma / wgmma (rows 0-7 k0-7, rows 8-15 k0-7, rows 0-7
// k8-15, rows 8-15 k8-15).
static __device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Four 8x8 bf16 matrices from registers to shared memory (r[i]: matrix i
// in the mma fragment layout, lane l holding row l / 4, columns 2(l % 4)
// and 2(l % 4) + 1); lane l gives the address of row l % 8 of matrix l / 8.
// The .trans form stores each matrix transposed (lane l then addresses
// column l % 8, as a row of the result).
static __device__ __forceinline__ void stmatrix_x4(unsigned addr, const unsigned* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

static __device__ __forceinline__ void stmatrix_x4_trans(unsigned addr, const unsigned* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 64 bf16 (128 B), 16-byte unit u of row n stored at unit u ^ (n % 8),
// 8-row atoms of 1024 B one after another (stride byte offset 1024; the
// leading byte offset is unused in this mode). The atom must be 1024-byte
// aligned; the k-th 16-wide slice of the rows starts 32 * k bytes in, which
// adds 2 * k to the descriptor.
static __device__ __forceinline__ unsigned long long wgmma_desc_sw128(unsigned saddr) {
  return (unsigned long long)((saddr & 0x3FFFF) >> 4) | ((unsigned long long)1 << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | ((unsigned long long)1 << 62);
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Orders this thread's earlier shared-memory writes (generic proxy) before
// later reads of the same bytes by wgmma (async proxy).
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads, whole warps.
static __device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Hands registers back to (dec) or takes them from (inc) the thread block's
// pool for the executing warpgroup; every warp of it runs the same
// instruction, and an inc waits until the pool holds enough.
template <int R>
static __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
static __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across a wgmma
// fence or wait (the tensor cores write them asynchronously).
template <int R>
static __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] @ B[16 x N] for one warpgroup: A bf16 from
// registers (a[4]: warp w's rows 16w..16w+15 as ldmatrix_x4 loads them), B
// bf16 K-major from shared memory through `desc`, f32 sums in d[N / 2] per
// thread: d[4j + e] is row 16w + lane/4 + 8(e/2), column 8j + 2(lane%4) +
// e%2. scale_d 0 overwrites d. The specialisations differ only in N
// (32, 64, 96, 128, 184, 240).
template <int N>
struct WgmmaRS;

template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float* d, const unsigned* a,
                                             unsigned long long desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float* d, const unsigned* a,
                                             unsigned long long desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaRS<184> {
  static __device__ __forceinline__ void mma(float* d, const unsigned* a,
                                             unsigned long long desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %97, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91"
        "}, {%92, %93, %94, %95}, %96, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};


template <> struct WgmmaRS<32> {
  static __device__ __forceinline__ void mma(float* d, const unsigned* a,
                                             unsigned long long desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaRS<96> {
  static __device__ __forceinline__ void mma(float* d, const unsigned* a,
                                             unsigned long long desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaRS<240> {
  static __device__ __forceinline__ void mma(float* d, const unsigned* a,
                                             unsigned long long desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %125, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119"
        "}, {%120, %121, %122, %123}, %124, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};


// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from shared to global memory, in this thread's current bulk group.
static __device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// Closes this thread's group of bulk copies to global memory.
static __device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared-memory source (the source may then be written again).
template <int N>
static __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete (their
// writes to global memory done).
template <int N>
static __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// 16-byte global store with the evict-first (streaming) cache hint: data
// that is read again only much later, and would push reused lines out of
// L2 meanwhile.
static __device__ __forceinline__ void st_global_cs16(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Orders this thread's earlier memory accesses, in every state space,
// against later ones of the async proxy (bulk copies, wgmma).
static __device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// Four 8x8 bf16 matrices, each loaded transposed: lane l gives the address
// of row l % 8 of matrix l / 8 (a row of the stored matrix); r[i] holds
// matrix i's transpose in the mma fragment layout.
static __device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d[64 x N] (+)= A[64 x 16] @ B[16 x N] for one warpgroup, both operands
// K-major in shared memory through descriptors (wgmma_desc_sw128), f32
// sums in d[N / 2] per thread in the WgmmaRS layout. The specialisations
// differ only in N (32, 128, 192, 256).
template <int N>
struct WgmmaSS;

template <> struct WgmmaSS<32> {
  static __device__ __forceinline__ void mma(float* d, unsigned long long adesc,
                                             unsigned long long bdesc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(adesc), "l"(bdesc), "r"(scale_d));
  }
};

template <> struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float* d, unsigned long long adesc,
                                             unsigned long long bdesc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(adesc), "l"(bdesc), "r"(scale_d));
  }
};

template <> struct WgmmaSS<192> {
  static __device__ __forceinline__ void mma(float* d, unsigned long long adesc,
                                             unsigned long long bdesc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(adesc), "l"(bdesc), "r"(scale_d));
  }
};

template <> struct WgmmaSS<256> {
  static __device__ __forceinline__ void mma(float* d, unsigned long long adesc,
                                             unsigned long long bdesc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(adesc), "l"(bdesc), "r"(scale_d));
  }
};


}  // namespace kair
