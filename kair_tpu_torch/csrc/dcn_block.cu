// Modulated deformable 3x3 convolution (DCNv2), inference, bf16, on Hopper's
// warpgroup products (sm_90a).
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
// 0, a tap outside (-1, H) x (-1, W) is 0) and the JAX package's offset
// layout (n, ho, wo, dg, K, 2), y first.
//
// Bound on the H100: at VRT-001's stage 1 (64x64, 120 -> 120 channels, 12
// groups) one call does 1.09 GFLOP and moves ~7.5 MB (x and out in bf16,
// the f32 offsets and mask): about 1.1 us of tensor-core time or 2.2 us of
// memory, so the bytes bound it. What a call costs in practice is the
// gather: four corners a tap and channel, at data-dependent places, from
// L1/L2 in 20- to 30-byte runs (a group's channels), and the share of the
// card the blocks cover: VRT's DCN calls run on 64x64 down to 8x8 maps, one
// image at inference.
//
// Design: an implicit GEMM on wgmma. A block takes a tile of 64 output
// pixels (the M of one wgmma) of one image and a run of K chunks; a chunk
// is one deformable group's taps t0 .. t0 + ntap - 1 at channels c0 .. c0 +
// csz - 1, at most 96 columns (all nine taps of cg 10 and 6, 90 and 54
// columns padded to 16; cg 15 in two chunks, six taps and three). Two
// warpgroups (256 threads), two blocks an SM. Per chunk:
//   - the tap table: one thread an entry (pixel, tap), consecutive threads
//     on the taps of one pixel, so the offsets and mask are read once each,
//     coalesced: the in-frame test, the four corners' element offsets (-1
//     outside the frame), their bilinear weights times the mask, and the
//     entry's first column in A, in shared memory;
//   - the column tile: one thread a (pixel, tap, channel pair), consecutive
//     threads on the pairs of one entry, so a warp's loads of a corner fall
//     in the same sectors; the pairs are 4-byte aligned in x (a group that
//     starts on an odd channel begins with a pair whose low half is unused),
//     so a corner is one load; a thread loads the corners of four items
//     before it uses any, and steps through its items without dividing;
//     the masked samples, rounded to bf16 (the product's operand), go into
//     the A tile, 64 rows in shared memory (a 16-byte row pad puts
//     ldmatrix's 8 rows in 8 bank groups);
//   - the products: the weight streams through a ring of two bulk-copied
//     stages (cp.async.bulk, mbarrier transaction counts), one a chunk,
//     written by pack_dcn_weight (ops/kernels/dcn_block.py) already in
//     wgmma's K-major 32-byte swizzle, 16 K values a slice, so a stage is
//     one copy of exactly the chunk's columns; warpgroup w multiplies A
//     (ldmatrix into registers) by the output column tiles w and w + 2 of
//     64 (one instance covers Cout <= 256), the f32 sums in registers across
//     the chunks. While one block of an SM gathers, the other's products run.
// Small maps: when the tiles are fewer than the card's SMs, the chunks
// (groups) of a tile are split over several blocks (split-K); each split
// writes f32 partials and a second kernel sums them in split order, adds
// the bias and rounds once to bf16, so the result is deterministic, with no
// float atomics. One split: the block adds the bias, rounds to bf16 and
// stores its tile (a contiguous run of 64 pixels) from shared memory in
// 16-byte pieces. Sums are f32 (the TPU kernel's sample matmul sums in the
// input type).
//
// Where a block's cycles go: kair_tpu_torch/cli/profile_dcn.py (a
// -DKAIR_PROFILE build; PERF.md has its split).
//
// Layouts (ops/kernels/dcn_block.py mirrors DcnPlan in dcn_plan): w the
// stages of every group's chunks in order, chunk q of group g at g *
// group_elems + the widths of the chunks before it times NP; a stage is kw /
// 16 slices of NP rows (output channels, zero past Cout) x 16 K values
// (rows of the chunk's (tap, channel) columns, tap-major, zero past 9 csz),
// 16-byte unit u of row n at unit u ^ (n / 4 % 2); x, out bf16 NHWC; off,
// mask, bias f32; part f32 [splits][N*H*W][Cout].
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kThreads = 256;          // two warpgroups
constexpr int kRows = 64;              // output pixels a tile: one wgmma's M
constexpr int kKMax = 96;              // columns of a chunk at most
constexpr int kLd = kKMax + 8;         // A row, bf16: 208 bytes
constexpr int kRing = 2;               // weight stages in shared memory
constexpr int kMaxCout = 256;          // four output column tiles of 64
constexpr int kU = 4;                  // column items a thread loads before using any

static __host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
static __host__ __device__ __forceinline__ int align1024(int v) { return (v + 1023) / 1024 * 1024; }

struct Chunk {
  int c0, csz, t0, ntap, kw;
};

// The chunking of a group's 9 cg columns and the shared-memory layout; the
// host mirror is ops/kernels/dcn_block.py :: dcn_plan, held to
// kair_dcn_plan by chip_smoke.py.
struct DcnPlan {
  int cg, cs, tpc, ntc, cpg, kmax, nt, np, group_elems, stage_bytes, ring_bytes, a_bytes,
      tab_bytes, smem;
  __host__ __device__ DcnPlan(int cin, int cout, int dg) {
    cg = cin / dg;
    const int nb = (cg + kKMax - 1) / kKMax;   // channel blocks of a group
    cs = (cg + nb - 1) / nb;
    tpc = imin(9, kKMax / cs);                 // taps a chunk
    ntc = (9 + tpc - 1) / tpc;
    cpg = nb * ntc;
    kmax = round16(tpc * cs);                  // the first chunk is the widest
    nt = (cout + 63) / 64;
    np = 64 * nt;
    group_elems = 0;
    for (int q = 0; q < cpg; ++q) group_elems += chunk(q).kw * np;
    stage_bytes = kmax * np * 2;
    // the ring also stages the bf16 output tile of a block with one split
    ring_bytes = align1024(imax(kRing * stage_bytes, kRows * np * 2));
    a_bytes = align1024(kRows * kLd * 2);
    tab_bytes = kRows * 9 * 36;                // the tap table: corners, weights, column
    smem = ring_bytes + a_bytes + tab_bytes + kRing * 8 + 1024;   // + barriers, slack
  }
  __host__ __device__ Chunk chunk(int q) const {
    const int b = q / ntc, tc = q - b * ntc;
    Chunk k;
    k.c0 = b * cs;
    k.csz = imin(cs, cg - k.c0);
    k.t0 = tc * tpc;
    k.ntap = imin(tpc, 9 - k.t0);
    k.kw = round16(k.ntap * k.csz);
    return k;
  }
  // element offset of chunk q (over all groups) in the packed weight
  __host__ __device__ long long offset(int q) const {
    const int g = q / cpg, r = q - g * cpg;
    long long off = (long long)g * group_elems;
    for (int i = 0; i < r; ++i) off += chunk(i).kw * np;
    return off;
  }
};

// Stage cycle profile, compiled in only with -DKAIR_PROFILE (the separate
// library that kair_tpu_torch/cli/profile_dcn.py builds): thread 0 of every
// block adds the SM clock cycles it spent in each stage: 0 the tap table, 1
// waiting at the table's barrier, 2 the column tile, 3 waiting at its
// barrier, 4 waiting for the weight stage, 5 the products.
#ifdef KAIR_PROFILE
constexpr int kDcnMarks = 6;
__device__ unsigned long long g_dcn_cycles[kDcnMarks];
#define DPROF_DECL() long long dprof_t = clock64(), dprof_acc[kDcnMarks] = {0, 0, 0, 0, 0, 0}
#define DPROF_MARK(i)                  \
  do {                                 \
    const long long t_ = clock64();    \
    dprof_acc[i] += t_ - dprof_t;      \
    dprof_t = t_;                      \
  } while (0)
#define DPROF_FLUSH()                                                                  \
  do {                                                                                 \
    if (threadIdx.x == 0)                                                              \
      for (int i_ = 0; i_ < kDcnMarks; ++i_)                                           \
        atomicAdd(&g_dcn_cycles[i_], (unsigned long long)dprof_acc[i_]);               \
  } while (0)
#else
#define DPROF_DECL() do {} while (0)
#define DPROF_MARK(i) do {} while (0)
#define DPROF_FLUSH() do {} while (0)
#endif

struct DcnArgs {
  const bf16* x;
  const float* off;
  const float* mask;
  const bf16* w;
  const float* bias;
  bf16* out;
  float* part;
  int N, H, W, Cin, Cout, DG, splits;
};

__global__ void __launch_bounds__(kThreads, 2) dcn_kernel(DcnArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const DcnPlan pl(a.Cin, a.Cout, a.DG);
  unsigned char* ring = smem;
  bf16* A = reinterpret_cast<bf16*>(smem + pl.ring_bytes);
  int4* tab_id = reinterpret_cast<int4*>(smem + pl.ring_bytes + pl.a_bytes);
  float4* tab_w = reinterpret_cast<float4*>(tab_id + kRows * 9);
  int* tab_col = reinterpret_cast<int*>(tab_w + kRows * 9);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      smem + pl.ring_bytes + pl.a_bytes + pl.tab_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.H, W = a.W, HW = H * W, Cin = a.Cin, DG = a.DG;
  const int tpi = (HW + kRows - 1) / kRows;
  const int tile = blockIdx.x / a.splits, split = blockIdx.x - tile * a.splits;
  const int n = tile / tpi, p0 = (tile - n * tpi) * kRows;
  const int rows = imin(kRows, HW - p0);
  // this split's chunks, in (group, chunk) order
  const int Q = DG * pl.cpg;
  const int q0 = (int)((long long)split * Q / a.splits);
  const int mine = (int)((long long)(split + 1) * Q / a.splits) - q0;

  auto issue = [&](int i) {   // the stage of chunk q0 + i into slot i % kRing
    const int q = q0 + i, slot = i % kRing;
    const unsigned bytes = (unsigned)(pl.chunk(q % pl.cpg).kw * pl.np * 2);
    mbar_arrive_expect_tx(&full[slot], bytes);
    bulk_copy_g2s(ring + slot * pl.stage_bytes, a.w + pl.offset(q), bytes, &full[slot]);
  };
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kRing && i < mine; ++i) issue(i);

  const int wg = warp >> 2, wq = warp & 3;
  const bool two = wg + 2 < pl.nt;          // this warpgroup's second column tile
  float acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  const unsigned a_row =
      smem_u32(A) + (unsigned)((wq * 16 + (lane & 15)) * kLd + (lane >> 4) * 8) * 2;
  const size_t pix0 = (size_t)n * HW;       // the image's first pixel
  const bf16* __restrict__ xn = a.x + pix0 * Cin;
  const bool pairs = Cin % 2 == 0 && ((size_t)a.x & 3) == 0;
  DPROF_DECL();

  for (int i = 0; i < mine; ++i) {
    const int q = q0 + i, g = q / pl.cpg;
    const Chunk ck = pl.chunk(q - g * pl.cpg);
    const int cb = g * pl.cg + ck.c0, csz = ck.csz, ntap = ck.ntap;
    // ---- the tap table: entry (row r, tap t0 + tl) = r * ntap + tl: its
    // corners' element offsets in the image (-1 outside the frame), their
    // weights times the mask, its first column in A ----------------------------
    for (int it = tid; it < kRows * ntap; it += kThreads) {
      const int r = it / ntap, tl = it - r * ntap, tap = ck.t0 + tl, pix = p0 + r;
      int4 id = make_int4(-1, -1, -1, -1);
      float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pix < HW) {
        const size_t gk = ((pix0 + pix) * DG + g) * 9 + tap;
        const int py = pix / W, px = pix - py * W;
        const float fy = (float)(py - 1 + tap / 3) + __ldg(a.off + 2 * gk);
        const float fx = (float)(px - 1 + tap % 3) + __ldg(a.off + 2 * gk + 1);
        const float m = __ldg(a.mask + gk);
        if (fy > -1.f && fy < (float)H && fx > -1.f && fx < (float)W) {
          const float y0f = floorf(fy), x0f = floorf(fx);
          const int y0 = (int)y0f, x0 = (int)x0f, base = y0 * W + x0;
          const float ly = fy - y0f, lx = fx - x0f;
          if (y0 >= 0 && x0 >= 0) { id.x = base * Cin; wt.x = (1.f - ly) * (1.f - lx) * m; }
          if (y0 >= 0 && x0 + 1 < W) { id.y = (base + 1) * Cin; wt.y = (1.f - ly) * lx * m; }
          if (y0 + 1 < H && x0 >= 0) { id.z = (base + W) * Cin; wt.z = ly * (1.f - lx) * m; }
          if (y0 + 1 < H && x0 + 1 < W) {
            id.w = (base + W + 1) * Cin;
            wt.w = ly * lx * m;
          }
        }
      }
      tab_id[it] = id;
      tab_w[it] = wt;
      tab_col[it] = r * kLd + tl * csz;
    }
    DPROF_MARK(0);
    __syncthreads();          // the table is ready; the last chunk's products are done
    if (tid == 0 && i >= 1 && i - 1 + kRing < mine) issue(i - 1 + kRing);
    DPROF_MARK(1);
    // ---- the column tile: item (entry, channel pair), consecutive threads on
    // the pairs of one entry; the pairs are 4-byte aligned in x (a group
    // starting on an odd channel begins with a pair whose low half is the
    // channel before it, unused), so each corner is one load; U items'
    // corners loaded before any is used; a thread steps its (entry, pair) by
    // kThreads items without dividing -------------------------------------------
    const int sh = pairs ? cb & 1 : 0;
    const int np2 = (csz + sh + 1) >> 1, n_items = kRows * ntap * np2;
    const int dq = kThreads / np2, dr = kThreads - dq * np2;
    const bf16* __restrict__ src = xn + cb;
    int ent = tid / np2, pr = tid - ent * np2;
    for (int e0 = tid; e0 < n_items; e0 += kU * kThreads) {
      unsigned raw[kU][4];
      int ents[kU], cs2[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = 2 * pr - sh;           // the pair's first channel, -1 .. csz - 1
        ents[u] = ent;
        cs2[u] = c;
        const int4 id = e0 + u * kThreads < n_items ? tab_id[ent] : make_int4(-1, -1, -1, -1);
        const int ids[4] = {id.x, id.y, id.z, id.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          raw[u][k] = 0u;
          if (ids[k] >= 0) {
            const bf16* p = src + ids[k] + c;
            if (pairs && c + 1 < csz) {
              raw[u][k] = *reinterpret_cast<const unsigned*>(p);
            } else {
              const unsigned lo = c >= 0 ? *reinterpret_cast<const unsigned short*>(p) : 0u;
              const unsigned hi =
                  c + 1 < csz ? *reinterpret_cast<const unsigned short*>(p + 1) : 0u;
              raw[u][k] = lo | hi << 16;
            }
          }
        }
        pr += dr;
        ent += dq;
        if (pr >= np2) {
          pr -= np2;
          ++ent;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (e0 + u * kThreads >= n_items) break;
        const float4 w4 = tab_w[ents[u]];
        const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw[u][k]));
          v0 += ws[k] * f.x;
          v1 += ws[k] * f.y;
        }
        const int c = cs2[u], col = tab_col[ents[u]] + c;
        bf16* dst = A + col;
        if (c >= 0 && c + 1 < csz && (col & 1) == 0) {
          *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c >= 0) dst[0] = __float2bfloat16(v0);
          if (c + 1 < csz) dst[1] = __float2bfloat16(v1);
        }
      }
    }
    // the chunk's padding columns
    const int width = ntap * csz, padw = ck.kw - width;
    for (int e = tid; e < kRows * padw; e += kThreads) {
      const int r = e / padw;
      A[r * kLd + width + (e - r * padw)] = __float2bfloat16(0.f);
    }
    DPROF_MARK(2);
    __syncthreads();          // A is ready
    DPROF_MARK(3);
    // ---- products: A (64 x kw) @ the stage, column tiles wg and wg + 2 ----------
    if (wg < pl.nt) {
      const int slot = i % kRing;
      mbar_wait(&full[slot], (i / kRing) & 1);
      DPROF_MARK(4);
      const unsigned b = smem_u32(ring + slot * pl.stage_bytes);
      const unsigned slice = (unsigned)pl.np * 32;
      unsigned af[2][4];
      for (int kk = 0; kk < ck.kw / 16; ++kk) {
        ldmatrix_x4(a_row + kk * 32, af[kk & 1]);
        fence_regs<32>(acc[0]);
        fence_regs<32>(acc[1]);
        wgmma_fence();
        WgmmaRS<64>::mma(acc[0], af[kk & 1], desc_narrow<32>(b + kk * slice + wg * 2048), 1);
        if (two)
          WgmmaRS<64>::mma(acc[1], af[kk & 1],
                           desc_narrow<32>(b + kk * slice + (wg + 2) * 2048), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<32>(acc[0]);
        fence_regs<32>(acc[1]);
      }
      wgmma_wait<0>();
      fence_regs<32>(acc[0]);
      fence_regs<32>(acc[1]);
    }
    DPROF_MARK(5);
  }
  DPROF_FLUSH();
  __syncthreads();            // every product done: the ring is free

  // ---- epilogue: acc[j][4jj + 2h + e] is row 16wq + lane/4 + 8h, column
  // 64(wg + 2j) + 8jj + 2(lane%4) + e
  const int Cout = a.Cout;
  if (a.splits == 1) {
    // + bias, bf16 into the ring (its stages are all consumed), then the
    // tile's rows, contiguous in out, in 16-byte pieces
    bf16* stg = reinterpret_cast<bf16*>(ring);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = wg + 2 * j;
      if (t >= pl.nt) break;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = t * 64 + 8 * jj + 2 * (lane & 3);
        if (col >= Cout) continue;
        const float b0 = __ldg(a.bias + col);
        const float b1 = col + 1 < Cout ? __ldg(a.bias + col + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wq * 16 + (lane >> 2) + 8 * h;
          bf16* d = stg + r * Cout + col;
          const float v0 = acc[j][4 * jj + 2 * h] + b0, v1 = acc[j][4 * jj + 2 * h + 1] + b1;
          if (Cout % 2 == 0) {
            *reinterpret_cast<bf162*>(d) = __floats2bfloat162_rn(v0, v1);
          } else {
            d[0] = __float2bfloat16(v0);
            if (col + 1 < Cout) d[1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();
    bf16* dst = a.out + (pix0 + p0) * Cout;
    const int ne = rows * Cout;
    if ((((size_t)dst) | (size_t)(ne * 2)) % 16 == 0) {
      for (int e = tid * 8; e < ne; e += kThreads * 8)
        *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(stg + e);
    } else {
      for (int e = tid; e < ne; e += kThreads) dst[e] = stg[e];
    }
  } else {
    // f32 partials of this split, straight from the registers
    float* part = a.part + ((size_t)split * a.N * HW + pix0 + p0) * Cout;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = wg + 2 * j;
      if (t >= pl.nt) break;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = t * 64 + 8 * jj + 2 * (lane & 3);
        if (col >= Cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wq * 16 + (lane >> 2) + 8 * h;
          if (r >= rows) continue;
          float* d = part + (size_t)r * Cout + col;
          if (Cout % 2 == 0) {
            *reinterpret_cast<float2*>(d) =
                make_float2(acc[j][4 * jj + 2 * h], acc[j][4 * jj + 2 * h + 1]);
          } else {
            d[0] = acc[j][4 * jj + 2 * h];
            if (col + 1 < Cout) d[1] = acc[j][4 * jj + 2 * h + 1];
          }
        }
      }
    }
  }
}

// out = bf16(part[0] + part[1] + ... + bias), the splits in order.
__global__ void __launch_bounds__(256) dcn_sum_kernel(const float* __restrict__ part,
                                                      const float* __restrict__ bias,
                                                      bf16* __restrict__ out, long long total,
                                                      int Cout, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float v = part[e];
    for (int s = 1; s < splits; ++s) v += part[s * total + e];
    out[e] = __float2bfloat16(v + bias[e % Cout]);
  }
}

}  // namespace

// x [N][H][W][Cin] bf16, off [N][H][W][DG][9][2] f32, mask [N][H][W][DG][9]
// f32, w the stages of pack_dcn_weight (bf16, 16-byte aligned), bias
// [Cout] f32, out [N][H][W][Cout] bf16, part [splits][N*H*W][Cout] f32
// (null with one split); splits in 1 .. DG * (chunks a group); N*H*W and
// H*W*Cin < 2^31.
extern "C" int kair_dcn(const void* x, const void* off, const void* mask, const void* w,
                        const void* bias, void* out, void* part, int N, int H, int W, int Cin,
                        int Cout, int DG, int splits, void* stream) {
  if (N < 0 || H < 1 || W < 1 || DG < 1 || Cin < 1 || Cin % DG || Cout < 1 ||
      Cout > kMaxCout || (long long)N * H * W >= (1LL << 31) ||
      (long long)H * W * Cin >= (1LL << 31) || (size_t)w % 16)
    return (int)cudaErrorInvalidValue;
  const DcnPlan pl(Cin, Cout, DG);
  if (splits < 1 || splits > DG * pl.cpg || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  DcnArgs a;
  a.x = static_cast<const bf16*>(x);
  a.off = static_cast<const float*>(off);
  a.mask = static_cast<const float*>(mask);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.N = N; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout; a.DG = DG; a.splits = splits;
  cudaError_t e = cudaFuncSetAttribute(dcn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)N * ((H * W + kRows - 1) / kRows);
  if (tiles == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dcn_kernel<<<(unsigned)(tiles * splits), kThreads, pl.smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess || splits == 1) return (int)e;
  const long long total = (long long)N * H * W * Cout;
  const long long blocks = (total + 255) / 256;
  dcn_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      a.part, a.bias, a.out, total, Cout, splits);
  return (int)cudaGetLastError();
}

// The layout the wrapper mirrors (dcn_plan): channels a block, taps a
// chunk, chunks a group, the widest chunk, NP, elements of a group's
// stages, bytes of a ring slot, dynamic shared memory.
extern "C" int kair_dcn_plan(int Cin, int Cout, int DG, int* dst) {
  if (DG < 1 || Cin < 1 || Cin % DG || Cout < 1) return (int)cudaErrorInvalidValue;
  const DcnPlan pl(Cin, Cout, DG);
  const int v[8] = {pl.cs, pl.tpc, pl.cpg, pl.kmax, pl.np, pl.group_elems, pl.stage_bytes,
                    pl.smem};
  for (int i = 0; i < 8; ++i) dst[i] = v[i];
  return 0;
}

#ifdef KAIR_PROFILE
// Copies the stage counters to dst[6] (host) and zeroes them.
extern "C" int kair_dcn_stage_cycles(unsigned long long* dst) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_dcn_cycles, sizeof(g_dcn_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kDcnMarks] = {};
  return (int)cudaMemcpyToSymbol(g_dcn_cycles, zero, sizeof(zero));
}
#endif
