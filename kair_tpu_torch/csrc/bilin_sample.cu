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
// size; the forward keeps a corner's pixel index, slab folded in, in 32 bits,
// so it takes G*H*W < 2^31 pixels in all (the wrapper checks).
//
// Forward design: a warp takes 64 consecutive rows. Each lane reads two
// rows' fy and fx (coalesced) and computes their four corners once, into
// shared memory (pixel index with the slab folded in, weight). The channels
// move in vectors, the widest the rows' byte alignment allows (the wrapper
// picks it: 16 B at Cs=48 bf16, 4 B (bf16x2) at VRT's Cs=10 bf16, whose
// 20-byte pixels are only 4-byte aligned, 2 or 4 B for an odd Cs); a row is
// V = Cs / vector items. The warp walks its rows' (row, vector) items: an
// item reads its row's corners from shared memory, one vector of each corner
// pixel, sums in f32 and stores one vector. The rows are consecutive in
// out, so a store instruction writes 32 consecutive vectors (whole sectors,
// no staging), and the lanes of a row read neighbouring vectors of a corner
// pixel. feat (7.9 MB at VRT-001) stays in L2. At random coordinates (the
// card check's) the gathers bound it: each load instruction touches about
// seven cache lines, about 5.8 L1 wavefronts a row with the corner reads from
// shared memory, at about one a clock per SM. Pairing the x-neighbours in
// one load, or the corners in registers passed by shuffles, measured slower.
// (The first version gave each row 8 lanes, whatever Cs, each recomputing
// the corners and moving 2-byte scalars: 0.267 ms at VRT's call.)
//
// Backward design. The first version gave each row 8 lanes that
// added every (row, corner, channel) share of dout into an f32 dfeat with a
// global atomicAdd: 141.6 M scalar atomics at VRT-001's stage-1 call, 0.847
// ms; the wrapper zero-filled dfeat and cast it after. A shared-memory f32
// tile summed by atomicAdd is no cure: Hopper has no shared-memory f32 add
// (it compiles to a compare-and-swap loop, ATOMS.CAST.SPIN) and ran 0.669
// ms there, 1.61 at Cs=48. So dfeat is gathered, not scattered, and written
// once, in feat's type, with no float atomic, no zero-fill and no cast pass,
// in two kernels:
//   - Pass 1, a row a thread: dfy and dfx (dout's row and the four corners'
//     feat pixels in vectors of the forward's widths, several vectors'
//     loads in flight, summed in f32 over the channels in a fixed order, so
//     they are deterministic); then the row is counted in each window of
//     dfeat that its corners of nonzero weight touch (one to four). A
//     window is th pixel rows x tw columns of one slab (the wrapper's
//     bwd_tiles picks them). A block's rows are counted per window in
//     shared memory first, so a block takes one global atomicAdd a window.
//     A block a slab then scans its windows' counts into list offsets, and
//     a fill pass, a row a thread again, appends each row's index to its
//     windows' lists. A row enters at most four lists, so a slab's lists
//     take at most 4 R entries: the scratch is 16 bytes a row and 8 a
//     window, linear in the frame.
//   - Pass 2, a thread block per window and channel chunk (tc channels): an
//     f32 tile of the window in shared memory, pixel stride tc | 1. It
//     takes its window's rows kChunk at a time, a row a thread: the row
//     copies its dout channels into the chunk's stage in shared memory and
//     links each corner of nonzero weight inside the window into its
//     pixel's list (entry 4 * row + corner holds the weight; an integer
//     atomicExch, native in shared memory, on the pixel's head makes it the
//     list's first). Then a thread takes a pixel, walks its list once for
//     every 16 channels, adds weight x the staged dout vectors in registers
//     and then into its own tile elements: no two threads add into one
//     element, and every read is from shared memory. Two list heads alternate
//     between chunks, so a chunk takes two barriers. Last the block writes
//     its window. The windows tile the frame, so every dfeat element is
//     written by exactly one block. The lists' order, and so dfeat's f32
//     sum, varies from run to run in its last bits.
// (One kernel in which every window's block scanned all its slab's rows
// took 0.69 ms at VRT-001's call: the scan, the chunks' barriers and the
// list walks of rows that mostly missed the window.) The backward is bound
// by bytes as the forward is: 143 MB at VRT-001's call, 0.043 ms at 3.35
// TB/s; it runs at a seventh of that (PERF.md).
// Coordinates are f32; feat, out and dout are f32 or bf16; dfeat is in
// feat's type.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kThreads = 256;                // forward

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

// A vector of VB bytes as one load or store.
template <int VB> struct Raw;
template <> struct Raw<16> { typedef uint4 t; };
template <> struct Raw<8> { typedef uint2 t; };
template <> struct Raw<4> { typedef unsigned t; };
template <> struct Raw<2> { typedef unsigned short t; };

constexpr int kWarpsFwd = kThreads / 32;
constexpr int kRowsPerWarp = 64;                // forward rows per warp

template <class T, int VB>
__global__ void __launch_bounds__(kThreads)
bilin_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ fy,
                 const float* __restrict__ fx, T* __restrict__ out, int H, int W, int Cs,
                 long long R, long long rows) {
  constexpr int N = VB / (int)sizeof(T);         // channels per vector
  typedef typename Raw<VB>::t V;
  // per warp: its rows' corner pixels (slab folded in) and weights
  __shared__ int4 cpix[kWarpsFwd][kRowsPerWarp];
  __shared__ float4 cwt[kWarpsFwd][kRowsPerWarp];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = ((long long)blockIdx.x * kWarpsFwd + warp) * kRowsPerWarp;
  if (base >= rows) return;                      // uniform over the warp
#pragma unroll
  for (int l = lane; l < kRowsPerWarp; l += 32) {
    const long long row = base + l;
    int4 pix = make_int4(0, 0, 0, 0);
    float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) {
      const Corners k = corners(fy[row], fx[row], H, W);
      const int g0 = (int)(row / R) * H * W;
      pix = make_int4(g0 + k.p[0], g0 + k.p[1], g0 + k.p[2], g0 + k.p[3]);
      wt = make_float4(k.w[0], k.w[1], k.w[2], k.w[3]);
    }
    cpix[warp][l] = pix;
    cwt[warp][l] = wt;
  }
  __syncwarp();
  const int nv = Cs / N;                         // vectors per row
  const int items = (int)min((long long)kRowsPerWarp, rows - base) * nv;
  const V* fv = reinterpret_cast<const V*>(feat);
  V* ov = reinterpret_cast<V*>(out + base * Cs);
#pragma unroll 4
  for (int it = lane; it < items; it += 32) {
    const int r = it / nv, v = it - r * nv;
    const int4 q = cpix[warp][r];
    const float4 c = cwt[warp][r];
    const int qi[4] = {q.x, q.y, q.z, q.w};
    const float ci[4] = {c.x, c.y, c.z, c.w};
    float acc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const V raw = fv[(long long)qi[i] * nv + v];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] += ci[i] * to_f(e[n]);
    }
    V o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int n = 0; n < N; ++n) oe[n] = from_f<T>(acc[n]);
    ov[it] = o;
  }
}

constexpr int kRowThreads = 256;               // pass 1 and the fill pass
constexpr int kScanThreads = 1024;             // the windows' scan, a block a slab
constexpr int kFillThreads = 256;              // the fill pass
constexpr int kBwdThreads = 512;               // pass 2
constexpr int kChunk = kBwdThreads;            // rows linked per pass, a row a thread
constexpr int kSmemMax = 232448;               // H100 opt-in bytes per block
constexpr int kMaxWindows = 24576;             // windows a slab: the fill pass's 192 KB histogram

// A window: th x tw pixels x tc channels of one slab's dfeat; nwy x nwx x
// nwc windows tile a slab. Pass 2's shared memory: the chunk's dout stage
// (kChunk rows x tc channels of es bytes; first, for its vectors'
// alignment), a weight and a next link for each of a chunk's 4 * kChunk
// corners, two list heads a pixel, the f32 tile.
struct BwdTiles {
  int th, tw, tc, tcp, nwy, nwx, nwc, es;
  __host__ __device__ int pixels() const { return th * tw; }
  __host__ __device__ int tile_floats() const { return pixels() * tcp; }
  __host__ __device__ long long smem_bytes() const {
    return 4LL * tile_floats() + 8LL * pixels() + 8LL * 4 * kChunk +
           (long long)kChunk * tc * es;
  }
};

// The floor corner of a coordinate, clamped before the conversion (a
// far-away tap must not overflow an int), and its fraction.
__device__ __forceinline__ int floor_clamped(float f, int n, float& t) {
  const float f0 = floorf(f);
  t = f - f0;
  return (int)fminf(fmaxf(f0, -2.f), (float)n);
}

// The windows along one axis that a row's two corner lines touch with
// nonzero weight (1 - t at c0, t at c0 + 1): a, then b if it differs; -1
// for none.
__device__ __forceinline__ void touched(int c0, float t, int n, int step, int& a, int& b) {
  a = c0 >= 0 && c0 < n && t < 1.f ? c0 / step : -1;
  b = t > 0.f && c0 + 1 >= 0 && c0 + 1 < n ? (c0 + 1) / step : -1;
  if (b == a) b = -1;
  if (a < 0) {
    a = b;
    b = -1;
  }
}

// A row's windows in its slab (one to four, -1 for none) and its rank in
// each among the block's rows: wcount [nwy * nwx] counts the block's rows
// per window in shared memory (native integer atomics, whose return is the
// rank). Every thread of the block calls it; on return wcount is final.
__device__ __forceinline__ void rank_rows(bool live, int y0, float ty, int x0, float tx, int H,
                                          int W, const BwdTiles& t, int* wcount, int key[4],
                                          int rank[4]) {
  const int nwyx = t.nwy * t.nwx;
  for (int i = threadIdx.x; i < nwyx; i += blockDim.x) wcount[i] = 0;
  int wya = -1, wyb = -1, wxa = -1, wxb = -1;
  if (live) {
    touched(y0, ty, H, t.th, wya, wyb);
    touched(x0, tx, W, t.tw, wxa, wxb);
  }
  __syncthreads();                              // wcount zeroed
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int wy = k & 2 ? wyb : wya, wx = k & 1 ? wxb : wxa;
    key[k] = wy >= 0 && wx >= 0 ? wy * t.nwx + wx : -1;
    rank[k] = key[k] >= 0 ? atomicAdd(&wcount[key[k]], 1) : 0;
  }
  __syncthreads();
}

// Pass 1: dfy, dfx and the windows' row counts. A block takes kRowThreads
// rows of one slab, a row a thread; counts [G][nwy * nwx] (zeroed) gets
// one global atomicAdd a window a block. (One atomicAdd a window a warp,
// its rows aggregated by __match_any_sync, left the whole call at 0.355 ms
// against 0.307 at VRT-001's call.)
template <class T, int VB>
__global__ void __launch_bounds__(kRowThreads, 4)
bilin_bwd_rows_kernel(const T* __restrict__ feat, const float* __restrict__ fy,
                      const float* __restrict__ fx, const T* __restrict__ dout,
                      float* __restrict__ dfy, float* __restrict__ dfx, int* __restrict__ counts,
                      int H, int W, int Cs, int R, BwdTiles t) {
  constexpr int N = VB / (int)sizeof(T);        // channels per vector
  constexpr int kBatch = VB >= 8 ? 2 : 4;   // vectors loaded at once
  typedef typename Raw<VB>::t V;
  extern __shared__ int wcount[];               // [nwy * nwx] rows
  const int nwyx = t.nwy * t.nwx;
  const int blocks = (R + kRowThreads - 1) / kRowThreads;   // a slab's
  const int g = blockIdx.x / blocks, r = blockIdx.x % blocks * kRowThreads + threadIdx.x;
  const long long row = (long long)g * R + r;
  const bool live = r < R;
  float ty = 0.f, tx = 0.f;
  int y0 = -2, x0 = -2;
  if (live) {
    y0 = floor_clamped(fy[row], H, ty);
    x0 = floor_clamped(fx[row], W, tx);
    const float hy[2] = {1.f - ty, ty}, hx[2] = {1.f - tx, tx};
    int fpix[4];                                // feat pixel, -1 outside the frame
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int y = y0 + (k >> 1), x = x0 + (k & 1);
      fpix[k] = y >= 0 && y < H && x >= 0 && x < W ? y * W + x : -1;
    }
    // the hat's derivative: 0 on both rows (columns) at an exact integer
    const float dy0 = ty > 0.f ? -1.f : 0.f, dy1 = ty > 0.f ? 1.f : 0.f;
    const float dx0 = tx > 0.f ? -1.f : 0.f, dx1 = tx > 0.f ? 1.f : 0.f;
    const V* fv = reinterpret_cast<const V*>(feat + (long long)g * H * W * Cs);
    const V* dv = reinterpret_cast<const V*>(dout + row * Cs);
    const int nv = Cs / N;
    float sy = 0.f, sx = 0.f;
    // kBatch vectors' loads at once (a zero vector past the row's end adds
    // exactly 0), then their sums in channel order
    for (int vb = 0; vb < nv; vb += kBatch) {
      V dr[kBatch], fr[4][kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool in = vb + j < nv;
        dr[j] = in ? dv[vb + j] : V();
#pragma unroll
        for (int k = 0; k < 4; ++k)                 // 0 outside the frame
          fr[k][j] = in && fpix[k] >= 0 ? fv[(long long)fpix[k] * nv + vb + j] : V();
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const T* e = reinterpret_cast<const T*>(&dr[j]);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float f[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) f[k] = to_f(reinterpret_cast<const T*>(&fr[k][j])[n]);
          const float go = to_f(e[n]);
          sy += go * (dy0 * (hx[0] * f[0] + hx[1] * f[1]) + dy1 * (hx[0] * f[2] + hx[1] * f[3]));
          sx += go * (dx0 * (hy[0] * f[0] + hy[1] * f[2]) + dx1 * (hy[0] * f[1] + hy[1] * f[3]));
        }
      }
    }
    dfy[row] = sy;
    dfx[row] = sx;
  }
  int key[4], rank[4];
  rank_rows(live, y0, ty, x0, tx, H, W, t, wcount, key, rank);
  for (int i = threadIdx.x; i < nwyx; i += kRowThreads)
    if (wcount[i] > 0) atomicAdd(&counts[(long long)g * nwyx + i], wcount[i]);
}

// A block a slab: its windows' row counts into the exclusive prefix sums
// that are their lists' starts in the slab's 4 R entries (64-bit: 4 R may
// pass 2^31); the counts zeroed again, as the fill pass's cursors.
__global__ void __launch_bounds__(kScanThreads)
bilin_bwd_scan_kernel(int* __restrict__ counts, unsigned long long* __restrict__ starts,
                      int nwyx) {
  __shared__ unsigned long long warp_sum[kScanThreads / 32];
  int* c = counts + (long long)blockIdx.x * nwyx;
  unsigned long long* st = starts + (long long)blockIdx.x * nwyx;
  const int per = (nwyx + kScanThreads - 1) / kScanThreads;
  const int i0 = min(nwyx, (int)threadIdx.x * per), i1 = min(nwyx, i0 + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long sum = 0;
  for (int i = i0; i < i1; ++i) sum += (unsigned)c[i];
  unsigned long long inc = sum;                 // the warp's inclusive scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {                              // the warps' exclusive scan
    const unsigned long long own = warp_sum[lane];
    unsigned long long ws = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long v = __shfl_up_sync(0xffffffffu, ws, d);
      if (lane >= d) ws += v;
    }
    warp_sum[lane] = ws - own;
  }
  __syncthreads();
  unsigned long long run = warp_sum[warp] + inc - sum;
  for (int i = i0; i < i1; ++i) {
    st[i] = run;
    run += (unsigned)c[i];
    c[i] = 0;
  }
}

// The fill pass: a block takes the rows pass 1's block took, ranks them per
// window again and takes one range of each window's list with one global
// atomicAdd on the window's cursor; the row goes to lists [G][4 R] at the
// window's start + the range + its rank. The cursors end at the counts.
__global__ void __launch_bounds__(kFillThreads)
bilin_bwd_fill_kernel(const float* __restrict__ fy, const float* __restrict__ fx,
                      int* __restrict__ cursor, const unsigned long long* __restrict__ starts,
                      int* __restrict__ lists, int H, int W, int R, BwdTiles t) {
  extern __shared__ int wcount[];               // [nwy * nwx] rows, then their ranges
  const int nwyx = t.nwy * t.nwx;
  int* woff = wcount + nwyx;
  const int blocks = (R + kFillThreads - 1) / kFillThreads;
  const int g = blockIdx.x / blocks, r = blockIdx.x % blocks * kFillThreads + threadIdx.x;
  const long long row = (long long)g * R + r;
  const bool live = r < R;
  float ty = 0.f, tx = 0.f;
  int y0 = -2, x0 = -2;
  if (live) {
    y0 = floor_clamped(fy[row], H, ty);
    x0 = floor_clamped(fx[row], W, tx);
  }
  int key[4], rank[4];
  rank_rows(live, y0, ty, x0, tx, H, W, t, wcount, key, rank);
  for (int i = threadIdx.x; i < nwyx; i += kFillThreads)
    if (wcount[i] > 0) woff[i] = atomicAdd(&cursor[(long long)g * nwyx + i], wcount[i]);
  __syncthreads();
  int* slab = lists + 4LL * g * R;
  const unsigned long long* st = starts + (long long)g * nwyx;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (key[k] >= 0) slab[st[key[k]] + woff[key[k]] + rank[k]] = r;
}

// Pass 2: a block per (slab, window, channel chunk), the slab slowest.
template <class T, int VB>
__global__ void __launch_bounds__(kBwdThreads, 2)
bilin_bwd_gather_kernel(const float* __restrict__ fy, const float* __restrict__ fx,
                        const T* __restrict__ dout, T* __restrict__ dfeat,
                        const int* __restrict__ counts,
                        const unsigned long long* __restrict__ starts,
                        const int* __restrict__ lists, int H,
                        int W, int Cs, int R, BwdTiles t) {
  constexpr int N = VB / (int)sizeof(T);        // channels per vector
  constexpr int kBatch = VB >= 16 ? 2 : VB == 8 ? 4 : 8;   // vectors loaded at once
  constexpr int kWalk = N >= 16 ? 1 : 16 / N;   // vectors summed in one walk of a list
  typedef typename Raw<VB>::t V;
  extern __shared__ uint4 smem[];
  V* stage = reinterpret_cast<V*>(smem);                          // [kChunk][tc / N]
  float* wt = reinterpret_cast<float*>(stage + kChunk * (t.tc / N));   // [4 * kChunk]
  int* nxt = reinterpret_cast<int*>(wt + 4 * kChunk);            // [4 * kChunk]
  int* heads = nxt + 4 * kChunk;                                 // [2][th * tw]
  float* tile = reinterpret_cast<float*>(heads + 2 * t.pixels());   // [th][tw][tcp]
  const int nb = t.nwy * t.nwx * t.nwc, in_slab = blockIdx.x % nb, g = blockIdx.x / nb;
  const int win_c = in_slab % t.nwc, win_x = in_slab / t.nwc % t.nwx,
            win_y = in_slab / (t.nwc * t.nwx);
  const int ty0 = win_y * t.th, tx0 = win_x * t.tw, tc0 = win_c * t.tc;
  const int ty1 = min(H, ty0 + t.th), tx1 = min(W, tx0 + t.tw), tc1 = min(Cs, tc0 + t.tc);
  const int tcp = t.tcp, nv = Cs / N, P = t.pixels(), tid = threadIdx.x;
  const int nvc = (tc1 - tc0) / N, v0 = tc0 / N, sv = t.tc / N;
  for (int i = tid; i < t.tile_floats(); i += kBwdThreads) tile[i] = 0.f;
  for (int i = tid; i < 2 * P; i += kBwdThreads) heads[i] = -1;

  const long long key = (long long)g * t.nwy * t.nwx + win_y * t.nwx + win_x;
  const int n_rows = counts[key];
  const int* list = lists + 4LL * g * R + starts[key];
  const long long base = (long long)g * R;
  const V* dv = reinterpret_cast<const V*>(dout + base * Cs);
  // this thread's row of the next chunk and its coordinates, loaded while
  // the current chunk is summed
  int nr = 0;
  float ny = 0.f, nx = 0.f;
  if (tid < n_rows) {
    nr = list[tid];
    ny = fy[base + nr];
    nx = fx[base + nr];
  }
  __syncthreads();
  for (int c0 = 0, pass = 0; c0 < n_rows; c0 += kChunk, pass ^= 1) {
    int* head = heads + pass * P;
    if (c0 + tid < n_rows) {
      const int r = nr;
      const float ry = ny, rx = nx;
      if (c0 + kChunk + tid < n_rows) {
        nr = list[c0 + kChunk + tid];
        ny = fy[base + nr];
        nx = fx[base + nr];
      }
      for (int vb = 0; vb < nvc; vb += kBatch) {   // kBatch loads in flight
        V buf[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (vb + j < nvc) buf[j] = dv[(long long)r * nv + v0 + vb + j];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (vb + j < nvc) stage[tid * sv + vb + j] = buf[j];
      }
      float ty, tx;
      const int y0 = floor_clamped(ry, H, ty);
      const int x0 = floor_clamped(rx, W, tx);
      const float hy[2] = {1.f - ty, ty}, hx[2] = {1.f - tx, tx};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int y = y0 + (k >> 1), x = x0 + (k & 1);
        const float w = hy[k >> 1] * hx[k & 1];
        if (w != 0.f && y >= ty0 && y < ty1 && x >= tx0 && x < tx1) {
          const int e = 4 * tid + k;
          wt[e] = w;
          nxt[e] = atomicExch(&head[(y - ty0) * t.tw + x - tx0], e);
        }
      }
    }
    __syncthreads();
    // a pixel a thread, its list walked once for every kWalk vectors (16
    // channels) in registers (a (pixel, vector) item a thread ran slower)
    int* spent = heads + (pass ^ 1) * P;         // the last chunk's heads
    for (int p = tid; p < P; p += kBwdThreads) {
      spent[p] = -1;
      const int e0 = head[p];
      if (e0 < 0) continue;
      float* dst = tile + p * tcp;
      for (int vw = 0; vw < nvc; vw += kWalk) {
        float acc[kWalk][N];
#pragma unroll
        for (int j = 0; j < kWalk; ++j)
#pragma unroll
          for (int n = 0; n < N; ++n) acc[j][n] = 0.f;
        for (int e = e0; e >= 0; e = nxt[e]) {
          const V* src = stage + (e >> 2) * sv + vw;
          const float w = wt[e];
#pragma unroll
          for (int j = 0; j < kWalk; ++j)
            if (vw + j < nvc) {
              const V raw = src[j];
              const T* d = reinterpret_cast<const T*>(&raw);
#pragma unroll
              for (int n = 0; n < N; ++n) acc[j][n] += w * to_f(d[n]);
            }
        }
#pragma unroll
        for (int j = 0; j < kWalk; ++j)
          if (vw + j < nvc)
#pragma unroll
            for (int n = 0; n < N; ++n) dst[(vw + j) * N + n] += acc[j][n];
      }
    }
    __syncthreads();
  }

  // the window's dfeat in feat's type, (pixel, vector) items: a window row's
  // pixels are contiguous in dfeat
  const int twn = tx1 - tx0;
  const int items = (ty1 - ty0) * twn * nvc;
  for (int it = tid; it < items; it += kBwdThreads) {
    const int p = it / nvc, v = it - p * nvc;
    const int yy = p / twn, xx = p - yy * twn;
    const float* src = tile + (yy * t.tw + xx) * tcp + v * N;
    V o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int n = 0; n < N; ++n) oe[n] = from_f<T>(src[n]);
    reinterpret_cast<V*>(dfeat + (((long long)g * H + ty0 + yy) * W + tx0 + xx) * Cs)[v0 + v] = o;
  }
}

}  // namespace

template <class T, int VB>
void launch_fwd(const void* feat, const float* fy, const float* fx, void* out, int H, int W,
                int Cs, long long R, long long rows, cudaStream_t s) {
  const long long per_block = (long long)kWarpsFwd * kRowsPerWarp;
  const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
  bilin_fwd_kernel<T, VB><<<grid, kThreads, 0, s>>>(static_cast<const T*>(feat), fy, fx,
                                                    static_cast<T*>(out), H, W, Cs, R, rows);
}

// feat [G][H][W][Cs], fy, fx [G][R] f32, out [G][R][Cs]; feat and out f32
// (bf16 = 0) or bf16 (bf16 = 1); vec: bytes per vector (2 (bf16 only), 4, 8
// or 16), dividing a pixel's bytes, feat and out aligned to it;
// G, H, W, Cs, R, bf16, vec, stream
extern "C" int kair_bilin_fwd(const void* feat, const void* fy, const void* fx, void* out,
                              int G, int H, int W, int Cs, int R, int bf16_io, int vec,
                              void* stream) {
  if (G < 0 || H < 1 || W < 1 || Cs < 1 || R < 0) return (int)cudaErrorInvalidValue;
  const int es = bf16_io ? 2 : 4;
  if (vec < es || vec > 16 || (vec & (vec - 1)) || (Cs * es) % vec ||
      ((size_t)feat | (size_t)out) % vec || (long long)G * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)G * R;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(fy);
  const float* x = static_cast<const float*>(fx);
  if (bf16_io) {
    switch (vec) {
      case 2: launch_fwd<bf16, 2>(feat, y, x, out, H, W, Cs, R, rows, s); break;
      case 4: launch_fwd<bf16, 4>(feat, y, x, out, H, W, Cs, R, rows, s); break;
      case 8: launch_fwd<bf16, 8>(feat, y, x, out, H, W, Cs, R, rows, s); break;
      default: launch_fwd<bf16, 16>(feat, y, x, out, H, W, Cs, R, rows, s);
    }
  } else {
    switch (vec) {
      case 4: launch_fwd<float, 4>(feat, y, x, out, H, W, Cs, R, rows, s); break;
      case 8: launch_fwd<float, 8>(feat, y, x, out, H, W, Cs, R, rows, s); break;
      default: launch_fwd<float, 16>(feat, y, x, out, H, W, Cs, R, rows, s);
    }
  }
  return (int)cudaGetLastError();
}

// The backward's arguments checked and its windows laid out; 0 or a
// cudaError_t.
int bwd_tiles_of(int G, int H, int W, int Cs, int R, int bf16_io, int vec, int th, int tw,
                 int tc, BwdTiles* t) {
  if (G < 0 || H < 1 || W < 1 || Cs < 1 || R < 0 || (long long)G * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int es = bf16_io ? 2 : 4;
  if (vec < es || vec > 16 || (vec & (vec - 1)) || (Cs * es) % vec)
    return (int)cudaErrorInvalidValue;
  if (th < 1 || tw < 1 || tc < 1 || (tc * es) % vec || (long long)th * tw * (tc | 1) >= (1LL << 26))
    return (int)cudaErrorInvalidValue;
  t->th = th; t->tw = tw; t->tc = tc; t->tcp = tc | 1; t->es = es;
  t->nwy = (H + th - 1) / th; t->nwx = (W + tw - 1) / tw; t->nwc = (Cs + tc - 1) / tc;
  if ((long long)G * t->nwy * t->nwx * t->nwc >= (1LL << 31) ||
      (long long)G * ((R + kRowThreads - 1) / kRowThreads) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (t->smem_bytes() > kSmemMax || t->nwy * t->nwx > kMaxWindows)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// The backward's scratch: the windows' row counts [G][nwy * nwx] int; from
// the next 16 bytes their lists' starts [G][nwy * nwx] 64-bit; the lists
// [G][4 R] int: 16 bytes a row and 12 a window.
struct BwdScratch {
  long long counts, starts, lists, bytes;       // byte offsets, and the total
  BwdScratch(int G, int R, const BwdTiles& t) {
    const long long windows = (long long)G * t.nwy * t.nwx;
    counts = 0;
    starts = (4 * windows + 15) / 16 * 16;
    lists = starts + 8 * windows;
    bytes = lists + 16LL * G * R;
  }
};

template <class T, int VB>
int launch_bwd(const void* feat, const float* fy, const float* fx, const void* dout,
               void* dfeat, float* dfy, float* dfx, char* scratch, int G, int H, int W, int Cs,
               int R, const BwdTiles& t, cudaStream_t s) {
  const BwdScratch sc(G, R, t);
  int* counts = reinterpret_cast<int*>(scratch + sc.counts);
  unsigned long long* starts = reinterpret_cast<unsigned long long*>(scratch + sc.starts);
  int* lists = reinterpret_cast<int*>(scratch + sc.lists);
  const int nwyx = t.nwy * t.nwx;
  const int smem = (int)t.smem_bytes(), hist = 8 * nwyx;
  cudaError_t e = cudaFuncSetAttribute(bilin_bwd_gather_kernel<T, VB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bilin_bwd_rows_kernel<T, VB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, hist);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bilin_bwd_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             hist);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)G * nwyx, s);
  if (e != cudaSuccess) return (int)e;
  if (R > 0) {
    const unsigned rgrid = (unsigned)((long long)G * ((R + kRowThreads - 1) / kRowThreads));
    bilin_bwd_rows_kernel<T, VB><<<rgrid, kRowThreads, hist, s>>>(
        static_cast<const T*>(feat), fy, fx, static_cast<const T*>(dout), dfy, dfx, counts, H, W,
        Cs, R, t);
  }
  bilin_bwd_scan_kernel<<<G, kScanThreads, 0, s>>>(counts, starts, nwyx);
  if (R > 0) {
    const unsigned fgrid = (unsigned)((long long)G * ((R + kFillThreads - 1) / kFillThreads));
    bilin_bwd_fill_kernel<<<fgrid, kFillThreads, hist, s>>>(fy, fx, counts, starts, lists, H, W,
                                                           R, t);
  }
  const unsigned grid = (unsigned)((long long)G * t.nwy * t.nwx * t.nwc);
  bilin_bwd_gather_kernel<T, VB><<<grid, kBwdThreads, smem, s>>>(
      fy, fx, static_cast<const T*>(dout), static_cast<T*>(dfeat), counts, starts, lists, H, W,
      Cs, R, t);
  return (int)cudaGetLastError();
}

// feat [G][H][W][Cs], fy, fx [G][R] f32, dout [G][R][Cs] and dfeat
// [G][H][W][Cs] in feat's type (f32: bf16 = 0, bf16: 1), every element of
// dfeat written; dfy, dfx [G][R] f32; scratch: kair_bilin_bwd_scratch_bytes
// bytes, 16-byte aligned; vec: bytes per vector as the forward's, dividing
// a pixel's bytes, feat, dout and dfeat aligned to it; th, tw, tc: a
// window of dfeat (pixel rows, columns, channels; tc a multiple of the
// vector's channels), whose pass-2 shared memory (BwdTiles::smem_bytes) is
// within the card's opt-in limit; G*H*W < 2^31.
// G, H, W, Cs, R, bf16, vec, th, tw, tc, stream
extern "C" int kair_bilin_bwd(const void* feat, const void* fy, const void* fx,
                              const void* dout, void* dfeat, void* dfy, void* dfx, void* scratch,
                              int G, int H, int W, int Cs, int R, int bf16_io, int vec, int th,
                              int tw, int tc, void* stream) {
  BwdTiles t;
  const int err = bwd_tiles_of(G, H, W, Cs, R, bf16_io, vec, th, tw, tc, &t);
  if (err) return err;
  if (((size_t)feat | (size_t)dout | (size_t)dfeat) % vec || (size_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(fy);
  const float* x = static_cast<const float*>(fx);
  float* dy = static_cast<float*>(dfy);
  float* dx = static_cast<float*>(dfx);
  char* sc = static_cast<char*>(scratch);
#define KAIR_BWD(T, VB) \
  launch_bwd<T, VB>(feat, y, x, dout, dfeat, dy, dx, sc, G, H, W, Cs, R, t, s)
  if (bf16_io) {
    switch (vec) {
      case 2: return KAIR_BWD(bf16, 2);
      case 4: return KAIR_BWD(bf16, 4);
      case 8: return KAIR_BWD(bf16, 8);
      default: return KAIR_BWD(bf16, 16);
    }
  }
  switch (vec) {
    case 4: return KAIR_BWD(float, 4);
    case 8: return KAIR_BWD(float, 8);
    default: return KAIR_BWD(float, 16);
  }
#undef KAIR_BWD
}

// Bytes of scratch kair_bilin_bwd takes at these arguments, or -1 where it
// refuses them.
extern "C" long long kair_bilin_bwd_scratch_bytes(int G, int H, int W, int Cs, int R, int bf16_io,
                                                  int vec, int th, int tw, int tc) {
  BwdTiles t;
  if (bwd_tiles_of(G, H, W, Cs, R, bf16_io, vec, th, tw, tc, &t)) return -1;
  return BwdScratch(G, R, t).bytes;
}

// Shared-memory bytes of a block of the backward's window pass at these
// arguments (BwdTiles::smem_bytes), or -1 where it refuses them.
extern "C" long long kair_bilin_bwd_shared_bytes(int G, int H, int W, int Cs, int R, int bf16_io,
                                                 int vec, int th, int tw, int tc) {
  BwdTiles t;
  if (bwd_tiles_of(G, H, W, Cs, R, bf16_io, vec, th, tw, tc, &t)) return -1;
  return t.smem_bytes();
}
