// 3x3 convolution + bias + residual with the cyclic un-roll folded into the
// read, NHWC, bf16 (sm_90a).
//
// Replaces the TPU kernel kair_tpu/ops/pallas/conv_block.py ::
// conv3x3_residual (_kernel). It computes
//
//   out = conv3x3_SAME(roll(y, (phase, phase))) + bias + res
//
// with y, res, out (B, H, W, C), C even. Un-rolled pixel (i, j) is read from
// y[(i-phase) mod H, (j-phase) mod W]; the zero padding lies at the
// un-rolled borders, as in the TPU kernel.
//
// Bound on the H100: at C=180 the conv does 2*9*C*C = 583,200 FLOP per pixel
// against 3*2*C = 1,080 bytes of activations (~540 FLOP/byte), so it is
// bound by tensor-core operations (0.155 ms at 989 TFLOP/s for B=16,
// 128x128).
//
// Design: an implicit GEMM on wgmma. M = output pixels, N = output channels
// (NT = 64, 128 or 184 a chunk; C > 184 takes several N chunks), K = 9 taps
// x the input channels in chunks of 64. A persistent grid, one block per SM,
// walks tiles of 6 rows x 32 columns (192 pixels). Each block has four
// warpgroups:
//   - three consumer warpgroups, two tile rows (64 pixels) each: one
//     m64nNTk16 wgmma per 16 input channels, A (the activations) from
//     registers loaded with ldmatrix from the halo, B (the weights) from
//     shared memory, f32 sums in registers (NT / 2 a thread); the next
//     k-step's ldmatrix runs while the current wgmma does;
//   - a producer warpgroup, which hands most of its registers to the
//     consumers (setmaxnreg): one thread streams the packed weight through a
//     ring of kRing stages, one (N chunk, K chunk, tap) tile of NT x 64 bf16
//     each, with one bulk copy (cp.async.bulk, mbarrier transaction count)
//     per stage (pack_conv3x3 writes each stage already in wgmma's K-major
//     128-byte-swizzle layout, so a stage is one contiguous copy); three
//     warps copy the 8 x 34 halo pixels of a tile, one 64-channel K chunk at
//     a time, into two alternating buffers with 8- or 4-byte cp.async copies
//     (zero-filled outside the frame and past C) that complete on an
//     mbarrier; the un-roll is folded into the source address.
// The nine taps of a K chunk are shifted views of its halo buffer: a tap
// moves each thread's ldmatrix row address by whole pixels, which a wgmma
// descriptor (whose swizzle atoms start on 8-row boundaries) could not
// express. The producers run ahead of the consumers, so the next stage's
// weights and the next chunk's (or tile's) halo load while the tensor cores
// work. The epilogue (one N chunk, as at C = 60 and 180): each consumer
// warpgroup prefetches its 64 pixels' residual into a staging buffer with
// 16-byte cp.async while its last K chunk computes, adds bias and residual
// to the f32 sums and rounds once to bf16 in place, then stores its two
// output runs (32 pixels x C, contiguous in out) as 16-byte vectors where
// they are aligned; with several N chunks it stores bf16 pairs from the
// registers. Edges are masked (W = 72, 126; channels >= C). The rolled map
// and the conv output never make a round trip through memory, and the
// weight is read from L2 once per 192 pixels (the first version read it
// once per 64, as WMMA fragments straight from L2, and took 1.99 ms at
// B=16, 128x128, C=180).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; cli/profile_conv.py): the products
// alone run at about 740 TFLOP/s; the rest is waiting for the weight ring
// (three stages: the halo buffers and the staging take the shared memory a
// fourth would need), for halo chunks, and the epilogue.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kTileRows = 6, kTileCols = 32;       // 192 output pixels
constexpr int kConsumerWGs = 3;                    // 2 tile rows each
constexpr int kHaloRows = kTileRows + 2, kHaloCols = kTileCols + 2;
constexpr int kHaloPix = kHaloRows * kHaloCols;    // 272
constexpr int kKC = 64;                            // input channels per K chunk
// bf16 per halo pixel: 144 bytes, an odd number of 16-byte units, so the 8
// rows of an ldmatrix phase fall in 8 different bank groups
constexpr int kHaloLd = kKC + 8;
constexpr int kHaloBytes = kHaloPix * kHaloLd * 2;  // one buffer, 39,168 B
constexpr int kRing = 3;                           // weight stages in flight
// the fourth warpgroup holds the producers: one weight warp, three halo warps
constexpr int kWeightWarp = kConsumerWGs * 4, kHaloWarps = 3;
constexpr int kThreads = (kConsumerWGs + 1) * 128;  // 512

// The layout that pack_conv3x3 (ops/kernels/conv_block.py) and the shared
// memory follow; conv_plan, stage_bytes and shared_bytes in the wrapper
// mirror it.
struct ConvPlan {
  int C, nt, n_chunks, k_chunks;
  __host__ __device__ explicit ConvPlan(int c) : C(c) {
    n_chunks = (C + 183) / 184;
    const int per = (C + n_chunks - 1) / n_chunks;
    nt = per <= 64 ? 64 : per <= 128 ? 128 : 184;
    k_chunks = (C + kKC - 1) / kKC;
  }
  __host__ __device__ int stage_bytes() const { return nt * kKC * 2; }
  __host__ __device__ int stages() const { return n_chunks * k_chunks * 9; }
  // with one N chunk each warpgroup stages its 64 output pixels (all C
  // channels, bf16) for the coalesced epilogue
  __host__ __device__ bool staged() const { return n_chunks == 1; }
  __host__ __device__ int stage_px_bytes() const { return staged() ? 64 * C * 2 : 0; }
  // from the 1024-byte aligned base: ring | halo x2 | staging x3 | barriers
  __host__ __device__ int halo_offset() const { return kRing * stage_bytes(); }
  __host__ __device__ int stg_offset() const { return halo_offset() + 2 * kHaloBytes; }
  __host__ __device__ int bar_offset() const {
    return stg_offset() + kConsumerWGs * stage_px_bytes();
  }
  __host__ __device__ int src_offset() const { return bar_offset() + (2 * kRing + 4) * 8; }
  // + the halo producer's source rows and columns, + 1024 of alignment slack
  __host__ __device__ int smem_bytes() const {
    return src_offset() + (kHaloRows + kHaloCols) * 4 + 1024;
  }
};

struct ConvArgs {
  const bf16* y;
  const bf16* res;
  const bf16* w;
  const float* bias;
  bf16* out;
  int B, H, W, C, phase;
};

// Stage cycle profile, compiled in only with -DKAIR_PROFILE (the separate
// library that kair_tpu_torch/cli/profile_conv.py builds): thread 0 of every
// block adds the SM clock cycles its warpgroup spent in each stage: 0 waiting
// for a halo chunk, 1 waiting for a weight stage, 2 the products (ldmatrix,
// wgmma and its wait), 3 the epilogue. g_conv_mode 1: the producers stay
// idle and the consumers run the products alone on whatever shared memory
// holds, storing nothing (the products' own time).
#ifdef KAIR_PROFILE
constexpr int kConvMarks = 4;
__device__ unsigned long long g_conv_cycles[kConvMarks];
__device__ int g_conv_mode;
#define CPROF_DECL() long long cprof_t = clock64(), cprof_acc[kConvMarks] = {0, 0, 0, 0}
#define CPROF_MARK(i)                  \
  do {                                 \
    const long long t_ = clock64();    \
    cprof_acc[i] += t_ - cprof_t;      \
    cprof_t = t_;                      \
  } while (0)
#define CPROF_FLUSH()                                                                  \
  do {                                                                                 \
    if (threadIdx.x == 0)                                                              \
      for (int i_ = 0; i_ < kConvMarks; ++i_)                                          \
        atomicAdd(&g_conv_cycles[i_], (unsigned long long)cprof_acc[i_]);              \
  } while (0)
#define PRODUCTS_ONLY() (g_conv_mode == 1)
#else
#define CPROF_DECL() do {} while (0)
#define CPROF_MARK(i) do {} while (0)
#define CPROF_FLUSH() do {} while (0)
#define PRODUCTS_ONLY() false
#endif

struct Tile {
  int b, i0, j0;
  __device__ Tile(int t, int H, int W) {
    const int n_ct = (W + kTileCols - 1) / kTileCols, n_rt = (H + kTileRows - 1) / kTileRows;
    j0 = (t % n_ct) * kTileCols;
    t /= n_ct;
    i0 = (t % n_rt) * kTileRows;
    b = t / n_rt;
  }
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_residual_kernel(ConvArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const ConvPlan pl(a.C);
  const int C = a.C, H = a.H, W = a.W;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* halo = reinterpret_cast<bf16*>(smem + pl.halo_offset());
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + pl.bar_offset());
  unsigned long long* empty = full + kRing;
  unsigned long long* hfull = empty + kRing;
  unsigned long long* hempty = hfull + 2;
  int* rowsrc = reinterpret_cast<int*>(smem + pl.src_offset());
  int* colsrc = rowsrc + kHaloRows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWGs * 4);   // lane 0 of every consumer warp
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(&hfull[h], kHaloWarps * 32);    // every lane of the halo warps
      mbar_init(&hempty[h], kConsumerWGs * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int tiles = a.B * ((H + kTileRows - 1) / kTileRows) * ((W + kTileCols - 1) / kTileCols);
  const int per_tile = pl.stages();
  const int stage_elems = NT * kKC;

  if (warp >= kWeightWarp) {
    // The producer warpgroup hands registers to the consumers: the block
    // starts with 128 a thread (65,536 in all) = 128 x 56 + 384 x 152.
    setmaxnreg_dec<56>();
    if (warp == kWeightWarp) {
      // ---- weights: one bulk copy per (N chunk, K chunk, tap) stage ------------
      if (lane == 0 && !PRODUCTS_ONLY()) {
        int s = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x)
          for (int i = 0; i < per_tile; ++i, ++s) {
            const int slot = s % kRing;
            mbar_wait(&empty[slot], ((s / kRing) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[slot], pl.stage_bytes());
            bulk_copy_g2s(ring + slot * stage_elems, a.w + (size_t)i * stage_elems,
                          pl.stage_bytes(), &full[slot]);
          }
      }
    } else {
      // ---- halo: 8 x 34 pixels x 64 channels per K chunk, two buffers ----------
      if (!PRODUCTS_ONLY()) {
        // 8-byte pieces where every pixel is 8-byte aligned (C % 4 == 0), else 4
        const int vec = C % 4 == 0 ? 4 : 2;            // channels per piece
        const int pieces = kKC / vec;                  // 16 or 32 per pixel
        const int hl = tid - (kWeightWarp + 1) * 32;   // 0 .. 95
        int hc = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const Tile tl(t, H, W);
          named_barrier_sync(1, kHaloWarps * 32);
          for (int r = hl; r < kHaloRows; r += kHaloWarps * 32) {
            const int iu = tl.i0 - 1 + r;
            rowsrc[r] = iu >= 0 && iu < H ? (tl.b * H + wrap(iu - a.phase, H)) * W : -1;
          }
          for (int c = hl; c < kHaloCols; c += kHaloWarps * 32) {
            const int ju = tl.j0 - 1 + c;
            colsrc[c] = ju >= 0 && ju < W ? wrap(ju - a.phase, W) : -1;
          }
          named_barrier_sync(1, kHaloWarps * 32);
          for (int nc = 0; nc < pl.n_chunks; ++nc)
            for (int kc = 0; kc < pl.k_chunks; ++kc, ++hc) {
              const int slot = hc & 1;
              mbar_wait(&hempty[slot], ((hc >> 1) & 1) ^ 1);
              bf16* dst = halo + slot * (kHaloBytes / 2);
              for (int idx = hl; idx < kHaloPix * pieces; idx += kHaloWarps * 32) {
                const int p = idx / pieces, ch = kc * kKC + (idx % pieces) * vec;
                const int rs = rowsrc[p / kHaloCols], cs = colsrc[p % kHaloCols];
                const bool in = rs >= 0 && cs >= 0 && ch < C;
                const bf16* src = in ? a.y + (size_t)(rs + cs) * C + ch : a.y;
                bf16* d = dst + p * kHaloLd + (ch - kc * kKC);
                if (vec == 4)
                  cp_async8(d, src, in ? 8 : 0);
                else
                  cp_async4(d, src, in ? 4 : 0);
              }
              cp_async_arrive(&hfull[slot]);
            }
        }
        cp_async_wait_all();
      }
    }
    return;
  }
  setmaxnreg_inc<152>();

  // ---- consumers: warpgroup g computes tile rows 2g, 2g+1 -------------------
  const int g = warp >> 2, wq = warp & 3, wt = tid & 127;
  // this thread's ldmatrix row: pixel m of the warpgroup's 64, at k offset 0/8
  const int m = wq * 16 + (lane & 15);
  const unsigned a_off =
      (unsigned)(((2 * g + (m >> 5)) * kHaloCols + (m & 31)) * kHaloLd + (lane >> 4) * 8) * 2;
  const unsigned ring_s = smem_u32(ring), halo_s = smem_u32(halo);
  bf16* stg = reinterpret_cast<bf16*>(smem + pl.stg_offset() + g * pl.stage_px_bytes());
  const bf16* __restrict__ res = a.res;
  const float* __restrict__ bias = a.bias;
  bf16* __restrict__ out = a.out;
  float acc[NT / 2];
  unsigned af[2][4];
  CPROF_DECL();
  int s = 0, hc = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl(t, H, W);
    // the warpgroup's two output runs: image rows i0 + 2g + r, `cols` pixels
    const int cols = min(kTileCols, W - tl.j0);
    for (int nc = 0; nc < pl.n_chunks; ++nc) {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < pl.k_chunks; ++kc, ++hc) {
        const int hslot = hc & 1;
        if (pl.staged() && kc == pl.k_chunks - 1 && !PRODUCTS_ONLY()) {
          // the residual of the warpgroup's 64 pixels into its staging
          // buffer, while the last K chunk computes
          named_barrier_sync(2 + g, 128);
          for (int r = 0; r < 2; ++r) {
            const int i = tl.i0 + 2 * g + r;
            if (i >= H) continue;
            const bf16* src = res + (((size_t)tl.b * H + i) * W + tl.j0) * C;
            bf16* dst = stg + r * kTileCols * C;
            const int n = cols * C;
            if ((((size_t)src) | (size_t)(n * 2)) % 16 == 0) {
              for (int e = wt * 8; e < n; e += 128 * 8) cp_async16(dst + e, src + e);
            } else {
              for (int e = wt * 2; e < n; e += 128 * 2) cp_async4(dst + e, src + e, 4);
            }
          }
          cp_async_commit();
        }
        if (!PRODUCTS_ONLY()) mbar_wait(&hfull[hslot], (hc >> 1) & 1);
        CPROF_MARK(0);
        const unsigned a_base = halo_s + hslot * kHaloBytes + a_off;
        // one k16 step at a time: ldmatrix into one of two A buffers while
        // the previous step's wgmma runs; a weight stage goes back to the
        // producer once its last step has completed (one step later)
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap, ++s) {
          const int slot = s % kRing;
          if (!PRODUCTS_ONLY()) mbar_wait(&full[slot], (s / kRing) & 1);
          CPROF_MARK(1);
          const unsigned a_tap = a_base + ((tap / 3) * kHaloCols + tap % 3) * kHaloLd * 2;
          const unsigned long long desc = wgmma_desc_sw128(ring_s + slot * pl.stage_bytes());
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ldmatrix_x4(a_tap + k * 32, af[k & 1]);
            fence_regs<NT / 2>(acc);
            wgmma_fence();
            WgmmaRS<NT>::mma(acc, af[k & 1], desc + 2 * k, 1);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs<NT / 2>(acc);
            if (k == 0 && tap > 0 && lane == 0 && !PRODUCTS_ONLY())
              mbar_arrive(&empty[(s - 1) % kRing]);
          }
          CPROF_MARK(2);
        }
        wgmma_wait<0>();
        fence_regs<NT / 2>(acc);
        if (lane == 0 && !PRODUCTS_ONLY()) {
          mbar_arrive(&empty[(s - 1) % kRing]);
          mbar_arrive(&hempty[hslot]);
        }
      }
      if (PRODUCTS_ONLY()) {
        CPROF_MARK(3);
        continue;
      }
      // ---- epilogue: + bias + residual in f32, one rounding to bf16 ------------
      // accumulator element d[4jj + 2h + e] is pixel mr = 16wq + lane/4 + 8h of
      // the warpgroup's 64, channel nc * NT + 8jj + 2(lane % 4) + e
      const int c0 = nc * NT + 2 * (lane & 3);
      if (pl.staged()) {
        // the residual waits in the staging buffer: each thread turns its
        // pairs into outputs in place, then the warpgroup stores its two runs
        // with 16-byte vectors where they are aligned
        cp_async_wait_all();
        named_barrier_sync(2 + g, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mr = wq * 16 + (lane >> 2) + 8 * h;
          if (tl.i0 + 2 * g + (mr >> 5) >= H || (mr & 31) >= cols) continue;
          bf162* px = reinterpret_cast<bf162*>(stg + ((mr >> 5) * kTileCols + (mr & 31)) * C);
#pragma unroll
          for (int jj = 0; jj < NT / 8; ++jj) {
            const int co = c0 + jj * 8;
            if (co < C) {
              const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + co));
              const float2 r = __bfloat1622float2(px[co / 2]);
              px[co / 2] = __floats2bfloat162_rn(acc[4 * jj + 2 * h] + bb.x + r.x,
                                                 acc[4 * jj + 2 * h + 1] + bb.y + r.y);
            }
          }
        }
        named_barrier_sync(2 + g, 128);
        for (int r = 0; r < 2; ++r) {
          const int i = tl.i0 + 2 * g + r;
          if (i >= H) continue;
          bf16* dst = out + (((size_t)tl.b * H + i) * W + tl.j0) * C;
          const bf16* src = stg + r * kTileCols * C;
          const int n = cols * C;
          if ((((size_t)dst) | (size_t)(n * 2)) % 16 == 0) {
            for (int e = wt * 8; e < n; e += 128 * 8)
              *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(src + e);
          } else {
            for (int e = wt * 2; e < n; e += 128 * 2)
              *reinterpret_cast<bf162*>(dst + e) = *reinterpret_cast<const bf162*>(src + e);
          }
        }
      } else {
        // several N chunks: bf16 pairs straight from registers
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mr = wq * 16 + (lane >> 2) + 8 * h;
          const int i = tl.i0 + 2 * g + (mr >> 5), j = tl.j0 + (mr & 31);
          if (i >= H || j >= W) continue;
          const size_t o = (((size_t)tl.b * H + i) * W + j) * C;
#pragma unroll
          for (int jj = 0; jj < NT / 8; ++jj) {
            const int co = c0 + jj * 8;
            if (co < C) {
              const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + co));
              const float2 r =
                  __bfloat1622float2(__ldg(reinterpret_cast<const bf162*>(res + o + co)));
              *reinterpret_cast<bf162*>(out + o + co) = __floats2bfloat162_rn(
                  acc[4 * jj + 2 * h] + bb.x + r.x, acc[4 * jj + 2 * h + 1] + bb.y + r.y);
            }
          }
        }
      }
      CPROF_MARK(3);
    }
  }
  CPROF_FLUSH();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int NT>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const ConvPlan pl(a.C);
  const int smem = pl.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(conv3x3_residual_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)a.B * ((a.H + kTileRows - 1) / kTileRows) *
                          ((a.W + kTileCols - 1) / kTileCols);
  if (tiles == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)(tiles < sm_count() ? tiles : sm_count());
  conv3x3_residual_kernel<NT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// y, res, out (B, H, W, C) bf16; w packed by pack_conv3x3 (the stage layout
// above); bias f32 (C); C even; w 16-byte aligned, y 8 (C % 4 == 0) or 4,
// res and out 4, bias 8; B*H*W < 2^31 (32-bit pixel offsets).
extern "C" int kair_conv3x3_residual(const void* y, const void* res, const void* w,
                                     const void* bias, void* out, int B, int H, int W,
                                     int C, int phase, void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 2 || C % 2 || (long long)B * H * W >= (1LL << 31) ||
      (size_t)w % 16 || (size_t)y % (C % 4 ? 4 : 8) || ((size_t)res | (size_t)out) % 4 ||
      (size_t)bias % 8)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.y = static_cast<const bf16*>(y);
  a.res = static_cast<const bf16*>(res);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.W = W; a.C = C; a.phase = phase;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ConvPlan(C).nt) {
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    default: return launch<184>(a, s);
  }
}

extern "C" int kair_conv3x3_shared_bytes(int C) { return ConvPlan(C).smem_bytes(); }

// N chunk width, N chunks, K chunks and bytes of one weight stage: the
// wrapper holds its packed weight and its checks to these.
extern "C" int kair_conv3x3_plan(int C, int* dst) {
  const ConvPlan pl(C);
  dst[0] = pl.nt;
  dst[1] = pl.n_chunks;
  dst[2] = pl.k_chunks;
  dst[3] = pl.stage_bytes();
  return 0;
}

#ifdef KAIR_PROFILE
// Copies the stage counters to dst[4] (host), zeroes them and sets the
// mode (0 full, 1 products only) for the launches that follow.
extern "C" int kair_conv_stage_cycles(unsigned long long* dst, int mode) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_conv_cycles, sizeof(g_conv_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kConvMarks] = {};
  e = cudaMemcpyToSymbol(g_conv_cycles, zero, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_conv_mode, &mode, sizeof(int));
}
#endif
