// Backward of the fused Swin block on 8x8 windows, training, bf16, on
// Hopper's warpgroup products (sm_90a): the entry kair_swin_block_2d_bwd.
//
// Replaces kair_tpu/ops/pallas/swin_block.py :: _fused_2d_bwd_pallas
// (_kernel_2d_bwd :219, pl.pallas_call :588). Given the block input x, the
// block's phase and dy, it recomputes the forward (LN1, qkv, softmax with the
// row max subtracted, rel-pos bias and optional 0/-100 mask, PV, proj,
// residual, LN2, fc1, exact GELU) and chains back to
//   dx (B,H,W,C) bf16, and f32 grads of qkv W/b, proj W/b, fc1 W/b, fc2 W/b,
//   norm1/norm2 weight and bias, and the (NH,64,64) score bias summed over
//   all windows.
// The block's cyclic shift is folded in: token (r, c) of window (wr, wc) is
// x[b, (8wr + r + phase) mod H, (8wc + c + phase) mod W], dy is taken at
// (8wr + r, 8wc + c) (the block's own, rolled, coordinates) and dx is
// written at x's own position.
//
// Bound on the H100: at SwinIR-M width the backward does 1,563,840 FLOP per
// token against 1,080 bytes of x, dy and dx, so it is bound by tensor-core
// operations: 0.117 ms at 989 TFLOP/s for B=32 48x48 (73,728 tokens).
//
// Design. Two passes, no float atomics: two launches on the same inputs
// give the same bits.
//   Pass 1 (swin_bwd_kernel), one window's chain, on the model of
//   csrc/swin_block_wgmma.cu: a persistent grid, one thread block per SM,
//   walks the windows two at a time (window 2t + g to warpgroup g). The
//   block is the two warpgroups alone, 256 threads: ptxas then gives each
//   thread up to 255 registers (with a producer warp or warpgroup it
//   compiled the chain at 168 and spilled 2.4 KB a thread). Pre-swizzled
//   weight stages (pack_bwd_stages, ops/kernels/swin_block.py) stream by
//   bulk copies through a two-slot ring that both windows read, in one
//   fixed order per window pair; the second warpgroup to finish with a
//   stage issues the copy that refills its slot (a shared-memory count of
//   the releases: no warp waits for another). Every product is a wgmma with
//   B from shared memory:
//     recompute: qkv per head (N 96), S = q k^T (N 64), O = P V (N 32), proj
//       per pair of heads (N = NT);
//     MLP, per hidden chunk of 64: pre = LN2(x1) W1 and dhid = dy W2^T
//       (N 64, their stages alternating, both issued before one wait), GELU
//       and GELU' (exact erf) on the registers, dh2 += dpre W1^T (N = NT);
//     attention, per pair of heads: dO = dx1 Wp^T (N 64); per head S again,
//       dP = dO V^T (N 64), dS = P (dP - rowsum(P dP)), dV = P^T dO and dK =
//       dS^T q (A from shared memory), dQ = dS k (A from registers), then
//       dh += [dq | dk] Wqkv^T (N = NT) from the registers; per pair dh +=
//       [dv | dv] Wqkv^T.
//   The transposed operands (v^T, P^T, dS^T, dO^T, q^T, k^T) are written to
//   shared memory by stmatrix (.trans), in the 128-byte swizzle the
//   descriptors read. LayerNorms, their backwards, the softmax and GELU run
//   on the accumulator registers (row statistics over the quad of lanes that
//   holds a row). A head's k|v and q^T|k^T tiles (16 KB) go to a per-
//   warpgroup scratch slot by one bulk copy in the recompute and come back by
//   one in the attention backward; LN2's normalised input x̂2 (then dx1) is
//   kept in f32 in the same slot, each thread reading back what it wrote.
//   x and dy arrive by cp.async, each warp its own rows; the next window's x
//   loads during the LN1 backward. The score-bias grad is summed per
//   warpgroup, the LayerNorm grads per warp, over their windows in a fixed
//   order, the rows read before the sums that add to them: 2 (8) partial
//   rows per thread block, not one per window.
//   Pass 1 also writes the operands of the four weight products, each in
//   64-token tiles (one window each), feature-major and swizzled as a
//   K-major wgmma operand, with evict-first stores (they are read only after
//   pass 1 ends, and would push the scratch out of L2): per window, LN1 out
//   (C rows), attention out (NH*32 rows, heads padded to 32), LN2 out (C),
//   GELU out (hidden), dpre (hidden), dy (C), dx1 (C), dqkv (NH*96, [q|k|v]
//   x heads padded to 32): 2*(4C + 2*hidden + NH*128) bytes a token, 4,416
//   at SwinIR-M width (the first design kept about 5.6 KB).
//   Pass 2 (swin_wgrad_kernel): D = A^T B per weight, A = the layer input
//   tiles (M rows, plus a row of ones that yields the bias grad), B = the
//   output-grad tiles, both streamed by bulk copies into a four-stage ring
//   (no tensor map: the tiles are already swizzled) that a producer warp
//   fills, two warpgroups on 128 rows of A against NB columns of B, split
//   over window ranges; the split partials and pass 1's partials are summed
//   in a fixed order (sum_rows_kernel).
//
// Rounding points as in the TPU kernel: q/k/v, the scaled q, P, O, the MLP
// hidden layer, dpre, dx1, dO, dS and dqkv bf16; f32 accumulation; x1, the
// LayerNorm inputs and the softmax f32.
//
// Layouts: the stage list (one window pair; NP = ceil(NH/2), KC =
// ceil(C/64), HC = ceil(hidden/64)):
//   for p < NP: qkv(h, k) for h of pair p, k < KC      (96 x 64)
//               proj(p)                                (NT x 64)
//   for j < HC: fc1(j, k), w2t(j, k) for k < KC        (64 x 64 each)
//               w1t(j)                                 (NT x 64)
//   for p < NP: wpt(p, k) k < KC                       (64 x 64)
//               qkt(h) for h of pair p                 (NT x 64)
//               vt(p)                                  (NT x 64)
// each stage row n holding its 64 K values with the 16-byte unit u stored at
// u ^ (n % 8). NT = 64, 128, 184 or 240, the narrowest that holds C.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kConsumerWGs = 2;                       // one window each
// Two warpgroups and nothing else: ptxas allocates registers for whole
// groups of four warps, so a producer warp or warpgroup beside them would
// hold every thread to 168 registers at compile time (whatever setmaxnreg
// hands the consumers at run time), and the window chain spills; at 256
// threads a thread may take 255.
constexpr int kThreads = kConsumerWGs * 128;          // 256
constexpr int kReleases = kConsumerWGs;               // warpgroups that read each stage
constexpr int kSmemLimit = 232448;                    // H100 opt-in bytes per block
// Two weight-ring slots: four ran 3% slower at SwinIR-M width (PERF.md),
// their shared memory coming out of L1
constexpr int kRing = 2;
constexpr int kHeadBytes = 16384;                     // a head's k|v and q^T|k^T tiles
constexpr int kAttnBytes = 28672;                     // k|v, q^T|k^T, dO^T, P^T / dS^T
constexpr int kStageWarp = 2048;                      // a warp's transposed-store staging
constexpr int kOps = 8;                               // stored operands of pass 2

static __host__ __device__ __forceinline__ int align1024(int v) {
  return (v + 1023) / 1024 * 1024;
}

// The layout that pack_bwd_stages, the shared memory and the scratch follow;
// the wrapper's bwd_plan mirrors it. From the 1024-byte aligned base:
//   kRing slots | per consumer warpgroup: A operand (LN1 / LN2 out, then dx1),
//   region B (dy, or a head's attention tiles), transposed-store staging |
//   LN w1 b1 w2 b2 | bqkv | b1 | bp (f32) | ring and head mbarriers, release
//   counts | the stage table
struct BwdPlan {
  int C, NH, hidden, nt, kc, np, hc, lda, slot, ab, rb, stages, scratch;
  __host__ __device__ BwdPlan(int c, int nh, int hid) : C(c), NH(nh), hidden(hid) {
    nt = c <= 64 ? 64 : c <= 128 ? 128 : c <= 184 ? 184 : 240;
    kc = (c + 63) / 64;
    np = (nh + 1) / 2;
    hc = (hid + 63) / 64;
    lda = kc * 64 + 8;               // a 16-byte pad: ldmatrix rows in 8 bank groups
    slot = imax(96, nt) * 128;
    ab = align1024(64 * lda * 2);
    rb = align1024(imax(64 * lda * 2, kAttnBytes));
    stages = nh * kc + np + hc * (2 * kc + 1) + np * kc + nh + np;
    scratch = nh * kHeadBytes + 64 * nt * 4;
  }
  __host__ __device__ int wg_bytes() const { return ab + rb + 4 * kStageWarp; }
  __host__ __device__ int wg_offset(int g) const { return kRing * slot + g * wg_bytes(); }
  __host__ __device__ int param_offset() const { return kRing * slot + kConsumerWGs * wg_bytes(); }
  __host__ __device__ int param_floats() const { return 4 * C + NH * 96 + hc * 64 + C; }
  __host__ __device__ int bar_offset() const { return param_offset() + align128(param_floats() * 4); }
  // full mbarriers, head mbarriers, release counts, then the stage table
  // (row offset and rows of each stage of a window pair)
  __host__ __device__ int table_offset() const {
    return bar_offset() + (kRing + kConsumerWGs) * 8 + kRing * 4;
  }
  __host__ __device__ int smem_bytes() const {
    return table_offset() + 2 * stages * 4 + 1024;
  }
  __host__ __device__ bool fits() const { return C <= 240 && smem_bytes() <= kSmemLimit; }
  // rows per window of the stored operands: LN1 out, attention out, LN2
  // out, GELU out, dpre, dy, dx1, dqkv
  __host__ __device__ int op_rows(int i) const {
    const int r[kOps] = {C, NH * 32, C, hidden, hidden, C, C, NH * 96};
    return r[i];
  }
};

struct BwdArgs {
  const bf16* x;
  const bf16* dy;
  const bf16* stages;
  const float* bqkv;
  const float* bp;
  const float* b1;
  const float* ln;
  const float* relbias;
  const float* mask;
  unsigned char* scratch;   // [2 * grid][plan.scratch]
  bf16* ops[kOps];          // [windows][rows][64] each
  float* part_bias;         // [2 * grid][NH][64][64]
  float* part_ln;           // [8 * grid][4][C]
  bf16* dx;
  float scale;
  int B, H, W, C, NH, hidden, phase;
};

// Profile build only (-DKAIR_PROFILE, kair_tpu_torch/cli/profile_swin_bwd.py):
// thread 0 of consumer warpgroup 0 of every block adds the SM clock cycles
// it spent in each stage: 0 load + LN1, 1 waiting for a weight stage, 2 the
// recompute's products and LN2, 3 attention forward (QK^T, softmax, PV), 4
// MLP backward (fc1, dhid, GELU, dh2, LN2 backward), 5 attention backward
// (dO, S, dP, dS, dQ/dK/dV), 6 dqkv Wqkv^T and the LN1 backward, 7 stores
// of the pass-2 operands, 8 waiting for a head's tiles, 9 the partial sums
// (score bias, LayerNorm grads).
#ifdef KAIR_PROFILE
constexpr int kMarks = 10;
__device__ unsigned long long g_bwd_cycles[kMarks];
#define WPROF_DECL() long long wp_t = clock64(), wp_acc[kMarks] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0}
#define WPROF(i)                     \
  do {                               \
    const long long t_ = clock64();  \
    wp_acc[i] += t_ - wp_t;          \
    wp_t = t_;                       \
  } while (0)
#define WPROF_FLUSH()                                                          \
  do {                                                                         \
    if (threadIdx.x == 0)                                                      \
      for (int i_ = 0; i_ < kMarks; ++i_)                                      \
        atomicAdd(&g_bwd_cycles[i_], (unsigned long long)wp_acc[i_]);          \
  } while (0)
#else
#define WPROF_DECL() do {} while (0)
#define WPROF(i) do {} while (0)
#define WPROF_FLUSH() do {} while (0)
#endif

static __device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

static __device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Warp wq's 16 tokens (rows 16wq .. 16wq + 15 of the window) of features
// [f0, f0 + 8 NFB) into a feature-major operand tile `tile` (F rows of 64
// tokens, 128 B each, 16-byte unit u of row f at u ^ (f % 8)); rows >= F are
// dropped. u[2 fb + hr] holds the mma fragment of the 8x8 matrix (token half
// hr, feature block fb), i.e. accumulator pairs in order. stmatrix.trans
// through the warp's own staging (row f of 32 bytes, its two 16-byte halves
// swapped on rows 4-7 of each 8 against bank conflicts), then 16-byte
// evict-first stores (pass 2 reads the tiles after pass 1 has finished, so
// they should not push the scratch and the partial rows out of L2): no
// barrier beyond the warp.
template <int NFB>
static __device__ __forceinline__ void store_T(const unsigned* u, unsigned char* stg,
                                               bf16* tile, int f0, int F, int wq, int lane) {
  const unsigned s = smem_u32(stg);
  const int rr = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int fb = 0; fb < NFB; fb += 2) {
    const int f = 8 * (fb + (mi >> 1)) + rr, hr = mi & 1;
    const unsigned r[4] = {u[2 * fb], u[2 * fb + 1], u[2 * fb + 2], u[2 * fb + 3]};
    stmatrix_x4_trans(s + f * 32 + ((hr ^ ((f >> 2) & 1)) << 4), r);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < NFB / 2; ++it) {
    const int item = lane + 32 * it, f = item >> 1, hu = item & 1, row = f0 + f;
    const uint4 v = *reinterpret_cast<const uint4*>(stg + f * 32 + ((hu ^ ((f >> 2) & 1)) << 4));
    if (row < F) st_global_cs16(tile + row * 64 + (((2 * wq + hu) ^ (row & 7)) << 3), v);
  }
  __syncwarp();
}

// Reduce-scatter of v[8][4] over the 8 lanes that share lane % 4 (lane bits
// 2-4): afterwards v[0] of lane l holds the sum over those lanes of group
// l >> 2. 28 shuffles instead of 96.
static __device__ __forceinline__ void butterfly8(float (&v)[8][4], int lane) {
#pragma unroll
  for (int st = 0; st < 3; ++st) {
    const int mask = 16 >> st, half = 4 >> st;
    const bool up = lane & mask;
#pragma unroll
    for (int jj = 0; jj < half; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = v[jj][e], hi = v[jj + half][e];
        const float keep = up ? hi : lo, send = up ? lo : hi;
        v[jj][e] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1) swin_bwd_kernel(BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const BwdPlan pl(a.C, a.NH, a.hidden);
  const int C = a.C, NH = a.NH, H = a.H, W = a.W, HID = a.hidden;
  constexpr int ring = kRing;
  constexpr int NJ = NT / 8;                 // accumulator column blocks
  constexpr int NCH = (NJ + 7) / 8;          // 64-column chunks
  // column block j of a 64-column chunk, clamped into the accumulator (the
  // blocks past NJ sit behind j < NJ tests)
  auto jc = [](int j) { return j < NJ ? j : NJ - 1; };
  float* s_ln = reinterpret_cast<float*>(smem + pl.param_offset());   // w1 b1 w2 b2
  float* s_bqkv = s_ln + 4 * C;
  float* s_b1 = s_bqkv + NH * 96;
  float* s_bp = s_b1 + pl.hc * 64;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + pl.bar_offset());
  unsigned long long* hbar = full + ring;    // one per warpgroup
  int* released = reinterpret_cast<int*>(hbar + kConsumerWGs);   // per slot, ever
  int* st_row = reinterpret_cast<int*>(smem + pl.table_offset());  // row offset
  int* st_rows = st_row + pl.stages;                                // rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < 4 * C; i += kThreads) s_ln[i] = a.ln[i];
  for (int i = tid; i < NH * 96; i += kThreads) s_bqkv[i] = a.bqkv[i];
  for (int i = tid; i < pl.hc * 64; i += kThreads) s_b1[i] = i < HID ? a.b1[i] : 0.f;
  for (int i = tid; i < C; i += kThreads) s_bp[i] = a.bp[i];
  const int nwr = H / 8, nwc = W / 8;
  const int windows = a.B * nwr * nwc;
  const int pairs = (windows + 1) / 2;
  // every stage this block reads, in order: the stage list once per pair
  const int total_stages =
      ((pairs - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * pl.stages;
  // copies stage i of the block's sequence into its ring slot
  auto issue = [&](int i) {
    if (i >= total_stages) return;
    const int slot = i % ring, k = i % pl.stages;
    mbar_arrive_expect_tx(&full[slot], st_rows[k] * 128);
    bulk_copy_g2s(smem + slot * pl.slot, a.stages + (size_t)st_row[k] * 64,
                  st_rows[k] * 128, &full[slot]);
  };
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    for (int g = 0; g < kConsumerWGs; ++g) mbar_init(&hbar[g], 1);
    mbar_fence_init();
    // the stage list of a window pair
    int n = 0, row = 0;
    auto put = [&](int rows) {
      st_row[n] = row;
      st_rows[n++] = rows;
      row += rows;
    };
    for (int p = 0; p < pl.np; ++p) {
      for (int h = 2 * p; h < 2 * p + 2 && h < NH; ++h)
        for (int k = 0; k < pl.kc; ++k) put(96);
      put(NT);
    }
    for (int j = 0; j < pl.hc; ++j) {
      for (int k = 0; k < 2 * pl.kc; ++k) put(64);
      put(NT);
    }
    for (int p = 0; p < pl.np; ++p) {
      for (int k = 0; k < pl.kc; ++k) put(64);
      for (int h = 2 * p; h < 2 * p + 2 && h < NH; ++h) put(NT);
      put(NT);
    }
    for (int i = 0; i < ring; ++i) issue(i);
  }
  __syncthreads();

  // ---- consumers: warpgroup g takes window 2t + g ------------------------------
  const int g = warp >> 2, wq = warp & 3, tw = tid & 127;
  const bool lead = tw == 0;                      // issues the warpgroup's bulk copies
  const int bar = 1 + g;
  const int slot_id = 2 * blockIdx.x + g;
  unsigned char* wgb = smem + pl.wg_offset(g);
  bf16* abA = reinterpret_cast<bf16*>(wgb);                  // [64][lda]
  unsigned char* rgB = wgb + pl.ab;                          // dy [64][lda] | attention tiles
  bf16* abB = reinterpret_cast<bf16*>(rgB);
  unsigned char* stg = wgb + pl.ab + pl.rb + wq * kStageWarp;
  const unsigned ring_s = smem_u32(smem);
  const unsigned kv_s = smem_u32(rgB), qkt_s = kv_s + 8192, t16_s = kv_s + 16384,
                 pds_s = kv_s + 20480;              // t16: v^T (forward) or dO^T
  unsigned char* scr = a.scratch + (size_t)slot_id * pl.scratch;
  float2* scr_f = reinterpret_cast<float2*>(scr + NH * kHeadBytes) + tw;   // [NT/4][128]
  const int lda = pl.lda;
  const unsigned a_rowA =
      smem_u32(abA) + (unsigned)((wq * 16 + (lane & 15)) * lda + (lane >> 4) * 8) * 2;
  const unsigned a_rowB = a_rowA + (unsigned)pl.ab;
  const int r0 = wq * 16 + (lane >> 2), q2 = 2 * (lane & 3);
  const int rr = lane & 7, mi = lane >> 3;
  const float scale = a.scale;
  const float kLog2e = 1.4426950408889634f;
  const float kNegInf = __int_as_float(0xff800000);
  const float* __restrict__ relbias = a.relbias;
  const float* __restrict__ maskp = a.mask;
  const float* lnw1 = s_ln;
  const float* lnb1 = s_ln + C;
  const float* lnw2 = s_ln + 2 * C;
  const float* lnb2 = s_ln + 3 * C;
  float* part_ln = a.part_ln + (size_t)(4 * slot_id + wq) * 4 * C;
  float* part_bias = a.part_bias + (size_t)slot_id * NH * 4096;

  auto wait_full = [&](int st) -> unsigned {
    const int slot = st % ring;
    mbar_wait(&full[slot], (st / ring) & 1);
    return ring_s + slot * pl.slot;
  };
  // the last warpgroup to release stage st refills its slot with stage st +
  // ring. A wgmma is one operation of the whole warpgroup: once the lead
  // thread has waited for the stage's last one, no warp of it reads the slot.
  auto release = [&](int st) {
    if (lead && atomicAdd(&released[st % ring], 1) == kReleases * (st / ring) + kReleases - 1)
      issue(st + ring);
  };

  float acc[NT / 2];
  int s = 0;
  unsigned hpar = 0;
  bool first = true;                  // the first window of this warpgroup stores its partials
  WPROF_DECL();

  // d (R f32 a thread) = A (this warp's 16 rows by ldmatrix, K chunks of 64)
  // @ the next pl.kc ring stages
  auto product = [&](auto& d, unsigned a_row, int mark) {
    constexpr int R = sizeof(decltype(d)) / sizeof(float);
    for (int k = 0; k < pl.kc; ++k, ++s) {
      unsigned af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a_row + (k * 64 + kk * 16) * 2, af[kk]);
      WPROF(mark);
      const unsigned base = wait_full(s);
      WPROF(1);
      const unsigned long long desc = wgmma_desc_sw128(base);
      fence_regs<R>(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaRS<2 * R>::mma(d, af[kk], desc + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<R>(d);
      release(s);
    }
  };
  // d1 = A1 @ W1 and d2 = A2 @ W2 with their K-chunk stages alternating in
  // the ring (W1 chunk k, W2 chunk k, ...): both products' wgmmas go out
  // before one wait
  auto product2 = [&](float (&d1)[32], unsigned a1, float (&d2)[32], unsigned a2, int mark) {
    for (int k = 0; k < pl.kc; ++k, s += 2) {
      unsigned af[4][4], bf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4(a1 + (k * 64 + kk * 16) * 2, af[kk]);
        ldmatrix_x4(a2 + (k * 64 + kk * 16) * 2, bf[kk]);
      }
      WPROF(mark);
      const unsigned long long da = wgmma_desc_sw128(wait_full(s));
      const unsigned long long db = wgmma_desc_sw128(wait_full(s + 1));
      WPROF(1);
      fence_regs<32>(d1);
      fence_regs<32>(d2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaRS<64>::mma(d1, af[kk], da + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaRS<64>::mma(d2, bf[kk], db + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(d1);
      fence_regs<32>(d2);
      release(s);
      release(s + 1);
    }
  };
  // acc (+)= fr (nk K steps of 16, four A-fragment registers each) @ the
  // next stage
  auto stage_into_acc = [&](const unsigned* fr, int nk, int mark) {
    WPROF(mark);
    const unsigned base = wait_full(s);
    WPROF(1);
    const unsigned long long desc = wgmma_desc_sw128(base);
    fence_regs<NT / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < nk) WgmmaRS<NT>::mma(acc, fr + 4 * kk, desc + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NT / 2>(acc);
    release(s++);
  };
  // row mean and 1/std of the accumulator's two rows over the C real columns
  auto row_stats = [&](float& mean0, float& mean1, float& rs0, float& rs1) {
    float sm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (8 * j + q2 < C) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sm[e] += acc[4 * j + e];
      }
    mean0 = quad_sum(sm[0] + sm[1]) / C;
    mean1 = quad_sum(sm[2] + sm[3]) / C;
    float vs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (8 * j + q2 < C) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = acc[4 * j + e] - (e < 2 ? mean0 : mean1);
          vs[e] += d * d;
        }
      }
    rs0 = rsqrtf(quad_sum(vs[0] + vs[1]) / C + 1e-5f);
    rs1 = rsqrtf(quad_sum(vs[2] + vs[3]) / C + 1e-5f);
  };
  // (x - mean) * rs * w + b of the accumulator into abA (bf16) and, by 64-
  // column chunks, into the operand tile `op` (C rows); with xs, the f32
  // normalised values also go to the scratch slot
  auto ln_out = [&](float mean0, float mean1, float rs0, float rs1, const float* w,
                    const float* b, bf16* op, bool xs) {
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      unsigned u[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = jc(8 * cc + jj), col = 8 * j + q2;
        unsigned p0 = 0u, p1 = 0u;
        if (8 * cc + jj < NJ) {
          float2 xh0 = make_float2(0.f, 0.f), xh1 = xh0;
          if (col < C) {
            xh0 = make_float2((acc[4 * j] - mean0) * rs0, (acc[4 * j + 1] - mean0) * rs0);
            xh1 = make_float2((acc[4 * j + 2] - mean1) * rs1, (acc[4 * j + 3] - mean1) * rs1);
            p0 = pack_bf16(xh0.x * w[col] + b[col], xh0.y * w[col + 1] + b[col + 1]);
            p1 = pack_bf16(xh1.x * w[col] + b[col], xh1.y * w[col + 1] + b[col + 1]);
            *reinterpret_cast<unsigned*>(abA + r0 * lda + col) = p0;
            *reinterpret_cast<unsigned*>(abA + (r0 + 8) * lda + col) = p1;
          }
          if (xs) {
            scr_f[(2 * j) * 128] = xh0;
            scr_f[(2 * j + 1) * 128] = xh1;
          }
        }
        u[2 * jj] = p0;
        u[2 * jj + 1] = p1;
      }
      store_T<8>(u, stg, op, 64 * cc, C, wq, lane);
    }
  };
  // The LayerNorm backward's sums in one pass over the columns: per-warp
  // column sums (over the warp's 16 rows of g x̂ and g, reduced by
  // butterfly8) added to (or, for the warpgroup's first window, stored in)
  // the warp's partial rows `pg` (d gamma) and `pg + C` (d beta), and the
  // row means m1, m2 over C of dz = g w and dz x̂. xh(j, hr) gives the
  // float2 x̂ of column pair j, row half hr; g is the accumulator. The
  // partial rows are read first, so their latency hides behind the sums.
  auto ln_bwd_sums = [&](float* pg, const float* w, auto xh, float (&m1)[2], float (&m2)[2]) {
    float2 og[NCH], ob[NCH];
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      const int col = 8 * (8 * cc + (lane >> 2)) + q2;
      og[cc] = ob[cc] = make_float2(0.f, 0.f);
      if (!first && col < C) {
        og[cc] = *reinterpret_cast<const float2*>(pg + col);
        ob[cc] = *reinterpret_cast<const float2*>(pg + C + col);
      }
    }
    float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      float v[8][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = jc(8 * cc + jj), col = 8 * j + q2;
        v[jj][0] = v[jj][1] = v[jj][2] = v[jj][3] = 0.f;
        if (8 * cc + jj < NJ && col < C) {
          const float2 x0 = xh(j, 0), x1 = xh(j, 1);
          v[jj][0] = acc[4 * j] * x0.x + acc[4 * j + 2] * x1.x;
          v[jj][1] = acc[4 * j + 1] * x0.y + acc[4 * j + 3] * x1.y;
          v[jj][2] = acc[4 * j] + acc[4 * j + 2];
          v[jj][3] = acc[4 * j + 1] + acc[4 * j + 3];
          const float w0 = w[col], w1 = w[col + 1];
          const float z00 = acc[4 * j] * w0, z01 = acc[4 * j + 1] * w1;
          const float z10 = acc[4 * j + 2] * w0, z11 = acc[4 * j + 3] * w1;
          sa[0] += z00 + z01;
          sb[0] += z00 * x0.x + z01 * x0.y;
          sa[1] += z10 + z11;
          sb[1] += z10 * x1.x + z11 * x1.y;
        }
      }
      butterfly8(v, lane);
      const int col = 8 * (8 * cc + (lane >> 2)) + q2;
      if (col < C) {
        *reinterpret_cast<float2*>(pg + col) =
            make_float2(og[cc].x + v[0][0], og[cc].y + v[0][1]);
        *reinterpret_cast<float2*>(pg + C + col) =
            make_float2(ob[cc].x + v[0][2], ob[cc].y + v[0][3]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m1[hr] = quad_sum(sa[hr]) / C;
      m2[hr] = quad_sum(sb[hr]) / C;
    }
  };

  // Window w's tokens of x into region B ([64][C], at x's own position: the
  // phase folded in) by 8- or 4-byte cp.async copies, each warp its own 16
  // rows (rows 16wq + i: window row 2wq + i / 8, column i % 8)
  auto fetch_x = [&](int w) {
    const int fc = w % nwc, fr = (w / nwc) % nwr, fb = w / (nwc * nwr);
    for (int i = 0; i < 16; ++i) {
      const int y = wrap(fr * 8 + 2 * wq + (i >> 3) + a.phase, H);
      const int xx = wrap(fc * 8 + (i & 7) + a.phase, W);
      const bf16* src = a.x + (((size_t)fb * H + y) * W + xx) * C;
      bf16* dst = abB + (16 * wq + i) * C;
      if (C % 4 == 0) {
        for (int c = 4 * lane; c < C; c += 128) cp_async8(dst + c, src + c, 8);
      } else {
        for (int c = 2 * lane; c < C; c += 64) cp_async4(dst + c, src + c, 4);
      }
    }
    cp_async_commit();
  };
  if (2 * (int)blockIdx.x + g < windows) fetch_x(2 * blockIdx.x + g);

  // zero abA's K padding once (only columns < C are ever written)
  for (int i = tw; i < 64 * (lda - C); i += 128) {
    const int t = i / (lda - C);
    abA[t * lda + C + i % (lda - C)] = __float2bfloat16(0.f);
  }

  for (int t = blockIdx.x; t < pairs; t += gridDim.x) {
    const int win = 2 * t + g;
    if (win >= windows) {
      // the ragged end: no window, but the ring's stages still pass
      for (int i = 0; i < pl.stages; ++i, ++s) {
        wait_full(s);
        release(s);
      }
      continue;
    }
    const int wc = win % nwc, wr = (win / nwc) % nwr, b = win / (nwc * nwr);
    const int wimg = wr * nwc + wc;
    bf16* op[kOps];
#pragma unroll
    for (int i = 0; i < kOps; ++i) op[i] = a.ops[i] + (size_t)win * pl.op_rows(i) * 64;
    // this thread's two tokens (rows r0, r0 + 8: window row 2wq + hr, column
    // lane / 4) at x's own position (the phase folded in)
    size_t xoff[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int y = wrap(wr * 8 + 2 * wq + hr + a.phase, H);
      const int xx = wrap(wc * 8 + (lane >> 2) + a.phase, W);
      xoff[hr] = (((size_t)b * H + y) * W + xx) * C;
    }

    // ---- x (fetched during the previous window) into the accumulator; LN1 ---------
    cp_async_wait_all();
    __syncwarp();                       // this warp's rows of x are in
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int col = 8 * j + q2;
        float2 v = make_float2(0.f, 0.f);
        if (col < C)
          v = __bfloat1622float2(*reinterpret_cast<const bf162*>(abB + (r0 + 8 * hr) * C + col));
        acc[4 * j + 2 * hr] = v.x;
        acc[4 * j + 2 * hr + 1] = v.y;
      }
    float mu1[2], rs1[2];
    row_stats(mu1[0], mu1[1], rs1[0], rs1[1]);
    WPROF(0);
    ln_out(mu1[0], mu1[1], rs1[0], rs1[1], lnw1, lnb1, op[0], false);
    WPROF(7);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {             // the residual stream starts at x + bp
      const int col = 8 * j + q2;
      if (col < C) {
        acc[4 * j] += s_bp[col];
        acc[4 * j + 1] += s_bp[col + 1];
        acc[4 * j + 2] += s_bp[col];
        acc[4 * j + 3] += s_bp[col + 1];
      }
    }
    __syncwarp();

    // ---- attention forward, a pair of heads at a time; proj after each pair ---------
    for (int p = 0; p < pl.np; ++p) {
      unsigned oa[2][2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = 2 * p + hh;
        if (h >= NH) break;
        float qkv[48];
#pragma unroll
        for (int i = 0; i < 48; ++i) qkv[i] = 0.f;
        product(qkv, a_rowA, 2);
        WPROF(2);
        const float* bq = s_bqkv + h * 96;
        // q scaled then rounded (as the TPU kernel), as A fragments and as
        // q^T; k and v token-major; v^T; k^T
        unsigned qa[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 16 * kk + 8 * (i >> 1) + q2;
            qa[kk][i] = pack_bf16((qkv[8 * kk + 2 * i] + bq[col]) * scale,
                                  (qkv[8 * kk + 2 * i + 1] + bq[col + 1]) * scale);
          }
        if (lead) bulk_wait_read<0>();   // the previous head's tiles are out
        named_barrier_sync(bar, 128);    // ... and its QK^T and PV are done
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          unsigned kr[4], vr[4], qr[4];
#pragma unroll
          for (int jd = 0; jd < 4; ++jd) {
            const int c = 8 * jd + q2;
            qr[jd] = qa[jd >> 1][(jd & 1) * 2 + hr];
            kr[jd] = pack_bf16(qkv[4 * (4 + jd) + 2 * hr] + bq[32 + c],
                               qkv[4 * (4 + jd) + 2 * hr + 1] + bq[33 + c]);
            vr[jd] = pack_bf16(qkv[4 * (8 + jd) + 2 * hr] + bq[64 + c],
                               qkv[4 * (8 + jd) + 2 * hr + 1] + bq[65 + c]);
          }
          const int tb = 2 * wq + hr;
          stmatrix_x4(kv_s + tb * 1024 + rr * 128 + ((mi ^ rr) << 4), kr);
          stmatrix_x4(kv_s + tb * 1024 + rr * 128 + (((4 + mi) ^ rr) << 4), vr);
          stmatrix_x4_trans(t16_s + mi * 1024 + rr * 128 + ((tb ^ rr) << 4), vr);
          stmatrix_x4_trans(qkt_s + mi * 1024 + rr * 128 + ((tb ^ rr) << 4), qr);
          stmatrix_x4_trans(qkt_s + 4096 + mi * 1024 + rr * 128 + ((tb ^ rr) << 4), kr);
        }
        fence_proxy_async();
        named_barrier_sync(bar, 128);
        if (lead) {
          bulk_copy_s2g(scr + h * kHeadBytes, rgB, kHeadBytes);
          bulk_commit();
        }

        // S = q k^T, the score bias loaded meanwhile; softmax
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        const unsigned long long kdesc = wgmma_desc_sw128(kv_s);
        fence_regs<32>(sc);
        wgmma_fence();
        WgmmaRS<64>::mma(sc, qa[0], kdesc, 0);
        WgmmaRS<64>::mma(sc, qa[1], kdesc + 2, 1);
        wgmma_commit();
        const float* rb = relbias + (size_t)h * 4096;
        const float* mk = maskp ? maskp + (size_t)wimg * 4096 : nullptr;
        float bias[32];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int o = (r0 + 8 * hr) * 64 + 8 * j + q2;
            float2 v = __ldg(reinterpret_cast<const float2*>(rb + o));
            if (mk) {
              const float2 m = __ldg(reinterpret_cast<const float2*>(mk + o));
              v.x += m.x;
              v.y += m.y;
            }
            bias[4 * j + 2 * hr] = v.x;
            bias[4 * j + 2 * hr + 1] = v.y;
          }
        wgmma_wait<0>();
        fence_regs<32>(sc);
        float m4[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * j + e] += bias[4 * j + e];
            m4[e] = fmaxf(m4[e], sc[4 * j + e]);
          }
        const float ms0 = quad_max(fmaxf(m4[0], m4[1])) * kLog2e;
        const float ms1 = quad_max(fmaxf(m4[2], m4[3])) * kLog2e;
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], kLog2e, e < 2 ? -ms0 : -ms1));
            s4[e] += sc[4 * j + e];
          }
        }
        const float inv0 = 1.f / quad_sum(s4[0] + s4[1]), inv1 = 1.f / quad_sum(s4[2] + s4[3]);
        unsigned pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float inv = (i & 1) ? inv1 : inv0;
            pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i] * inv, sc[8 * kk + 2 * i + 1] * inv);
          }
        // O = P V
        float o[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) o[i] = 0.f;
        const unsigned long long vdesc = wgmma_desc_sw128(t16_s);
        fence_regs<16>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaRS<32>::mma(o, pa[kk], vdesc + 2 * kk, kk != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<16>(o);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            oa[hh][kk][i] = pack_bf16(o[8 * kk + 2 * i], o[8 * kk + 2 * i + 1]);
        WPROF(3);
        store_T<4>(&oa[hh][0][0], stg, op[1], 32 * h, NH * 32, wq, lane);
        WPROF(7);
      }
      // proj of the pair: head 2p is K 0..31 of the stage, head 2p+1 K 32..63
      stage_into_acc(&oa[0][0][0], 2 * p + 1 < NH ? 4 : 2, 2);
      WPROF(2);
    }

    // ---- region B is free: dy's tokens load during LN2 -------------------------------
    if (lead) bulk_wait_read<0>();
    named_barrier_sync(bar, 128);       // every warp's QK^T and PV are done
    for (int i = 0; i < 16; ++i) {      // this warp's own rows
      const int tk = 16 * wq + i;
      bf16* dst = abB + tk * lda;
      const bf16* src = a.dy + (((size_t)b * H + wr * 8 + (tk >> 3)) * W + wc * 8 + (tk & 7)) * C;
      if (C % 4 == 0) {
        for (int c = 4 * lane; c < C; c += 128) cp_async8(dst + c, src + c, 8);
      } else {
        for (int c = 2 * lane; c < C; c += 64) cp_async4(dst + c, src + c, 4);
      }
      for (int c = C + lane; c < pl.kc * 64; c += 32) dst[c] = __float2bfloat16(0.f);
    }
    cp_async_commit();

    // ---- LN2 of x1 (the accumulator): x̂2 to the scratch slot, LN2 out -> abA ---------
    float mu2[2], rs2[2];
    row_stats(mu2[0], mu2[1], rs2[0], rs2[1]);
    ln_out(mu2[0], mu2[1], rs2[0], rs2[1], lnw2, lnb2, op[2], true);
    WPROF(7);
    cp_async_wait_all();
    __syncwarp();                      // this warp's dy rows are in
    // dy as the dy operand (from region B by ldmatrix)
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      unsigned u[16];
#pragma unroll
      for (int fb = 0; fb < 8; fb += 2) {
        const int row = 16 * wq + 8 * (mi & 1) + rr, col = 8 * (8 * cc + fb + (mi >> 1));
        ldmatrix_x4(smem_u32(abB) + (unsigned)(row * lda + col) * 2, &u[2 * fb]);
      }
      store_T<8>(u, stg, op[5], 64 * cc, C, wq, lane);
    }
    WPROF(7);

    // ---- MLP backward by hidden chunks of 64: pre, dhid, GELU, dpre, dh2 ------------
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < pl.hc; ++j) {
      float pre[32], dh[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pre[i] = dh[i] = 0.f;
      product2(pre, a_rowA, dh, a_rowB, 4);
      const float* bb = s_b1 + j * 64;
      unsigned gu[16], du[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float gv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * (i >> 1) + q2 + e;
          const float uu = pre[2 * i + e] + bb[col];
          const float cdf = 0.5f * (1.f + erff(uu * 0.70710678118654752f));
          const float pdf = 0.3989422804014327f * __expf(-0.5f * uu * uu);
          gv[e] = uu * cdf;
          dv[e] = j * 64 + col < HID ? dh[2 * i + e] * (cdf + uu * pdf) : 0.f;
        }
        gu[i] = pack_bf16(gv[0], gv[1]);
        du[i] = pack_bf16(dv[0], dv[1]);
      }
      WPROF(4);
      store_T<8>(gu, stg, op[3], 64 * j, HID, wq, lane);
      store_T<8>(du, stg, op[4], 64 * j, HID, wq, lane);
      WPROF(7);
      stage_into_acc(du, 4, 4);
      WPROF(4);
    }

    // ---- LN2 backward: dx1 = dy + LN2^T(dh2); dx1 -> scratch, abA, its operand -------
    {
      auto xh2 = [&](int j, int hr) { return scr_f[(2 * j + hr) * 128]; };
      WPROF(4);
      float m1[2], m2[2];
      ln_bwd_sums(part_ln + 2 * C, lnw2, xh2, m1, m2);
      WPROF(9);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) {
        unsigned u[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = jc(8 * cc + jj), col = 8 * j + q2;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            unsigned pk = 0u;
            if (8 * cc + jj < NJ) {
              float2 d = make_float2(0.f, 0.f);
              if (col < C) {
                const float2 x = xh2(j, hr);
                const float2 yv = __bfloat1622float2(
                    *reinterpret_cast<const bf162*>(abB + (r0 + 8 * hr) * lda + col));
                const float dz0 = acc[4 * j + 2 * hr] * lnw2[col];
                const float dz1 = acc[4 * j + 2 * hr + 1] * lnw2[col + 1];
                d.x = yv.x + rs2[hr] * (dz0 - m1[hr] - x.x * m2[hr]);
                d.y = yv.y + rs2[hr] * (dz1 - m1[hr] - x.y * m2[hr]);
                pk = pack_bf16(d.x, d.y);
                *reinterpret_cast<unsigned*>(abA + (r0 + 8 * hr) * lda + col) = pk;
              }
              scr_f[(2 * j + hr) * 128] = d;
            }
            u[2 * jj + hr] = pk;
          }
        }
        store_T<8>(u, stg, op[6], 64 * cc, C, wq, lane);
      }
    }
    WPROF(4);

    // ---- attention backward, head by head; dh = dqkv Wqkv^T accumulates --------------
    if (lead) {
      bulk_wait<0>();                   // the head tiles are written
      fence_proxy_async_all();
    }
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    named_barrier_sync(bar, 128);       // every warp is done with dy in region B
    if (lead) {
      mbar_arrive_expect_tx(&hbar[g], kHeadBytes);
      bulk_copy_g2s(rgB, scr, kHeadBytes, &hbar[g]);
    }
    for (int p = 0; p < pl.np; ++p) {
      unsigned dva[2][2][4];
      // dO = dx1 Wp^T for the pair of heads (head 2p columns 0-31, 2p+1 32-63)
      unsigned dopair[2][2][4];
      {
        float dof[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dof[i] = 0.f;
        product(dof, a_rowA, 5);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dopair[hh][kk][i] = pack_bf16(dof[16 * hh + 8 * kk + 2 * i],
                                            dof[16 * hh + 8 * kk + 2 * i + 1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = 2 * p + hh;
        if (h >= NH) break;
        // this head's dO^T into region B
        const unsigned (&doa)[2][4] = dopair[hh];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const unsigned r[4] = {doa[0][hr], doa[0][2 + hr], doa[1][hr], doa[1][2 + hr]};
          stmatrix_x4_trans(t16_s + mi * 1024 + rr * 128 + (((2 * wq + hr) ^ rr) << 4), r);
        }
        fence_proxy_async();
        WPROF(5);
        mbar_wait(&hbar[g], hpar);      // this head's k|v and q^T|k^T are in
        hpar ^= 1;
        WPROF(8);
        named_barrier_sync(bar, 128);   // dO^T is whole
        // this head's score-bias partial, read now and added to after dS
        float* pb = part_bias + (size_t)h * 4096;
        float2 pold[16];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            pold[2 * j + hr] = first ? make_float2(0.f, 0.f)
                                     : *reinterpret_cast<const float2*>(
                                           pb + (r0 + 8 * hr) * 64 + 8 * j + q2);
        // q (scaled) as A fragments from q^T
        unsigned qa[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int dim = 16 * kk + 8 * (mi >> 1) + rr, tb = 2 * wq + (mi & 1);
          ldmatrix_x4_trans(qkt_s + dim * 128 + ((tb ^ (dim & 7)) << 4), qa[kk]);
        }
        // S again, softmax to f32 P
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        const unsigned long long kvdesc = wgmma_desc_sw128(kv_s);
        fence_regs<32>(sc);
        wgmma_fence();
        WgmmaRS<64>::mma(sc, qa[0], kvdesc, 0);
        WgmmaRS<64>::mma(sc, qa[1], kvdesc + 2, 1);
        wgmma_commit();
        const float* rb = relbias + (size_t)h * 4096;
        const float* mk = maskp ? maskp + (size_t)wimg * 4096 : nullptr;
        float bias[32];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int o = (r0 + 8 * hr) * 64 + 8 * j + q2;
            float2 v = __ldg(reinterpret_cast<const float2*>(rb + o));
            if (mk) {
              const float2 m = __ldg(reinterpret_cast<const float2*>(mk + o));
              v.x += m.x;
              v.y += m.y;
            }
            bias[4 * j + 2 * hr] = v.x;
            bias[4 * j + 2 * hr + 1] = v.y;
          }
        wgmma_wait<0>();
        fence_regs<32>(sc);
        float m4[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * j + e] += bias[4 * j + e];
            m4[e] = fmaxf(m4[e], sc[4 * j + e]);
          }
        const float ms0 = quad_max(fmaxf(m4[0], m4[1])) * kLog2e;
        const float ms1 = quad_max(fmaxf(m4[2], m4[3])) * kLog2e;
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], kLog2e, e < 2 ? -ms0 : -ms1));
            s4[e] += sc[4 * j + e];
          }
        const float inv0 = 1.f / quad_sum(s4[0] + s4[1]), inv1 = 1.f / quad_sum(s4[2] + s4[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * j + e] *= e < 2 ? inv0 : inv1;
        // P^T into region B: matrix (query half hr, key block j) transposed
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int j4 = 0; j4 < 2; ++j4) {
            unsigned r[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 4 * j4 + i;
              r[i] = pack_bf16(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]);
            }
            stmatrix_x4_trans(pds_s + (4 * j4 + mi) * 1024 + rr * 128 +
                                  (((2 * wq + hr) ^ rr) << 4), r);
          }
        fence_proxy_async();
        named_barrier_sync(bar, 128);   // P^T is whole
        // dP = dO V^T (A from registers) and dV = P^T dO (A from P^T)
        float dp[32], dv[16];
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) dv[i] = 0.f;
        const unsigned long long pdesc = wgmma_desc_sw128(pds_s);
        const unsigned long long odesc = wgmma_desc_sw128(t16_s);
        fence_regs<32>(dp);
        fence_regs<16>(dv);
        wgmma_fence();
        WgmmaRS<64>::mma(dp, doa[0], kvdesc + 4, 0);
        WgmmaRS<64>::mma(dp, doa[1], kvdesc + 6, 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaSS<32>::mma(dv, pdesc + 2 * kk, odesc + 2 * kk, kk != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(dp);
        fence_regs<16>(dv);
        // dS = P (dP - rowsum(P dP)); its sum over windows is the score-bias grad
        float rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) rsum[e >> 1] += sc[4 * j + e] * dp[4 * j + e];
        rsum[0] = quad_sum(rsum[0]);
        rsum[1] = quad_sum(rsum[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - rsum[e >> 1]);
        WPROF(5);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<float2*>(pb + (r0 + 8 * hr) * 64 + 8 * j + q2) =
                make_float2(pold[2 * j + hr].x + dp[4 * j + 2 * hr],
                            pold[2 * j + hr].y + dp[4 * j + 2 * hr + 1]);
        WPROF(9);
        unsigned dsa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dsa[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
        // dS^T over P^T (dV, the only reader, has completed for the whole
        // warpgroup: no warp can pass the wait before every warp issued it)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int j4 = 0; j4 < 2; ++j4) {
            unsigned r[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 4 * j4 + i;   // key block j: dsa[j / 2][(j % 2) * 2 + hr]
              r[i] = dsa[j >> 1][(j & 1) * 2 + hr];
            }
            stmatrix_x4_trans(pds_s + (4 * j4 + mi) * 1024 + rr * 128 +
                                  (((2 * wq + hr) ^ rr) << 4), r);
          }
        fence_proxy_async();
        named_barrier_sync(bar, 128);   // dS^T is whole
        // dQ = dS k (B = k^T), dK = dS^T q (A = dS^T, B = q^T)
        float dq[16], dk[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) dq[i] = dk[i] = 0.f;
        const unsigned long long ktdesc = wgmma_desc_sw128(qkt_s + 4096);
        const unsigned long long qtdesc = wgmma_desc_sw128(qkt_s);
        fence_regs<16>(dq);
        fence_regs<16>(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaRS<32>::mma(dq, dsa[kk], ktdesc + 2 * kk, kk != 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaSS<32>::mma(dk, pdesc + 2 * kk, qtdesc + 2 * kk, kk != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<16>(dq);
        fence_regs<16>(dk);
        // the next head's tiles load while this one finishes (every read of
        // region B's k|v and q^T|k^T tiles is a completed wgmma or an
        // ldmatrix before it)
        if (lead && h + 1 < NH) {
          mbar_arrive_expect_tx(&hbar[g], kHeadBytes);
          bulk_copy_g2s(rgB, scr + (h + 1) * kHeadBytes, kHeadBytes, &hbar[g]);
        }
        unsigned dqa[2][4], dka[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dqa[kk][i] = pack_bf16(dq[8 * kk + 2 * i] * scale, dq[8 * kk + 2 * i + 1] * scale);
            dka[kk][i] = pack_bf16(dk[8 * kk + 2 * i], dk[8 * kk + 2 * i + 1]);
            dva[hh][kk][i] = pack_bf16(dv[8 * kk + 2 * i], dv[8 * kk + 2 * i + 1]);
          }
        WPROF(5);
        store_T<4>(&dqa[0][0], stg, op[7], 96 * h, NH * 96, wq, lane);
        store_T<4>(&dka[0][0], stg, op[7], 96 * h + 32, NH * 96, wq, lane);
        store_T<4>(&dva[hh][0][0], stg, op[7], 96 * h + 64, NH * 96, wq, lane);
        WPROF(7);
        // dh += [dq | dk] Wqkv^T
        const unsigned qk[4][4] = {
            {dqa[0][0], dqa[0][1], dqa[0][2], dqa[0][3]},
            {dqa[1][0], dqa[1][1], dqa[1][2], dqa[1][3]},
            {dka[0][0], dka[0][1], dka[0][2], dka[0][3]},
            {dka[1][0], dka[1][1], dka[1][2], dka[1][3]}};
        stage_into_acc(&qk[0][0], 4, 6);
        WPROF(6);
      }
      // dh += [dv(2p) | dv(2p+1)] Wqkv^T
      stage_into_acc(&dva[0][0][0], 2 * p + 1 < NH ? 4 : 2, 6);
      WPROF(6);
    }

    // ---- LN1 backward: dx = dx1 + LN1^T(dh), at x's own position -----------------
    // region B is free (the last head's wgmmas are done): the warp's rows of
    // this warpgroup's next window load meanwhile
    {
      const int next = 2 * (t + gridDim.x) + g;
      if (next < windows) fetch_x(next);
    }
    {
      // x once, packed (the LN1 backward reads it twice)
      unsigned xp[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          xp[j][hr] = 8 * j + q2 < C
                          ? *reinterpret_cast<const unsigned*>(a.x + xoff[hr] + 8 * j + q2)
                          : 0u;
      auto xh1 = [&](int j, int hr) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(&xp[j][hr]));
        return make_float2((v.x - mu1[hr]) * rs1[hr], (v.y - mu1[hr]) * rs1[hr]);
      };
      WPROF(6);
      float m1[2], m2[2];
      ln_bwd_sums(part_ln, lnw1, xh1, m1, m2);
      WPROF(9);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + q2;
        if (col < C) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float2 x = xh1(j, hr), d1 = scr_f[(2 * j + hr) * 128];
            const float dz0 = acc[4 * j + 2 * hr] * lnw1[col];
            const float dz1 = acc[4 * j + 2 * hr + 1] * lnw1[col + 1];
            *reinterpret_cast<unsigned*>(a.dx + xoff[hr] + col) =
                pack_bf16(d1.x + rs1[hr] * (dz0 - m1[hr] - x.x * m2[hr]),
                          d1.y + rs1[hr] * (dz1 - m1[hr] - x.y * m2[hr]));
          }
        }
      }
    }
    first = false;
    named_barrier_sync(bar, 128);       // every warp is done with this window's tiles
    WPROF(6);
  }
  if (first) {
    // a warpgroup without a window: its partial rows are zero
    for (int i = tw; i < NH * 4096; i += 128) part_bias[i] = 0.f;
    for (int i = lane; i < 4 * C; i += 32) part_ln[i] = 0.f;
  }
  if (lead) bulk_wait<0>();
  WPROF_FLUSH();
}

// ---------------------------------------------------------------------------
// Pass 2: D = A^T B of the four weight products over the stored tiles
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 288;       // two consumer warpgroups, one producer warp
constexpr int kWgStages = 4;

struct WgProduct {
  const bf16* A;      // [windows][FA][64]
  const bf16* B;      // [windows][FB][64]
  int FA, FB, MP, NP;  // rows of A and B; D is [MP][NP]
  int item0;          // first work item
  long long d_off;    // D's offset in a partial
};

struct WgradArgs {
  WgProduct p[4];
  int items, windows, wps;
  long long total;    // floats of one partial
  float* part;        // [splits][total]
};

template <int NB>
__global__ void __launch_bounds__(kWgThreads, 1) swin_wgrad_kernel(WgradArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kA = 128 * 128, kStage = kA + NB * 128;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + kWgStages * kStage);
  unsigned long long* empty = full + kWgStages;
  const int item = blockIdx.x % a.items, split = blockIdx.x / a.items;
  int q = 0;
  while (q < 3 && item >= a.p[q + 1].item0) ++q;
  const WgProduct pr = a.p[q];
  const int nch = pr.NP / NB, local = item - pr.item0;
  const int m0 = (local / nch) * 128, n0 = (local % nch) * NB;
  const int w0 = split * a.wps, w1 = min(a.windows, w0 + a.wps);
  const int rows_a = max(0, min(128, pr.FA - m0)), rows_b = min(NB, pr.FB - n0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // A's rows past its last real row: the ones row (the bias grad), then zeros
  const int fill = (128 - rows_a) * 8;           // 16-byte units
  for (int i = tid; i < kWgStages * fill; i += kWgThreads) {
    const int st = i / fill, rem = i % fill, row = rows_a + rem / 8;
    const unsigned v = m0 + row == pr.FA ? 0x3F803F80u : 0u;   // bf16 1.0 pairs
    reinterpret_cast<uint4*>(smem + st * kStage + row * 128)[rem % 8] = make_uint4(v, v, v, v);
  }
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  fence_proxy_async();
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      for (int w = w0, i = 0; w < w1; ++w, ++i) {
        const int slot = i % kWgStages;
        mbar_wait(&empty[slot], ((i / kWgStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[slot], (rows_a + rows_b) * 128);
        unsigned char* st = smem + slot * kStage;
        if (rows_a)
          bulk_copy_g2s(st, pr.A + ((size_t)w * pr.FA + m0) * 64, rows_a * 128, &full[slot]);
        bulk_copy_g2s(st + kA, pr.B + ((size_t)w * pr.FB + n0) * 64, rows_b * 128, &full[slot]);
      }
    }
    return;
  }
  const int g = warp >> 2;
  const bool active = m0 + 64 * g <= pr.FA;     // rows of this half exist (the ones row counts)
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  const unsigned base = smem_u32(smem);
  for (int w = w0, i = 0; w < w1; ++w, ++i) {
    const int slot = i % kWgStages;
    mbar_wait(&full[slot], (i / kWgStages) & 1);
    if (active) {
      const unsigned st = base + slot * kStage;
      const unsigned long long ad = wgmma_desc_sw128(st + g * 8192);
      const unsigned long long bd = wgmma_desc_sw128(st + kA);
      fence_regs<NB / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaSS<NB>::mma(acc, ad + 2 * kk, bd + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NB / 2>(acc);
    }
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
  float* out = a.part + (size_t)split * a.total + pr.d_off;
  const int wq = warp & 3, r0 = m0 + 64 * g + wq * 16 + (lane >> 2), q2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(out + (size_t)(r0 + 8 * hr) * pr.NP + n0 + 8 * j + q2) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
}

// dst[j] = Σ_r src[r][j] in a fixed order (the same sum on every run): a
// block takes 32 columns; thread (g, c) sums rows g, g + 8, ... of column
// c in order, then the eight group sums are added in order.
__global__ void __launch_bounds__(256) sum_rows_kernel(const float* __restrict__ src, int rows,
                                                       long long cols, float* __restrict__ dst) {
  __shared__ float part[8][32];
  const int c = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const long long j = (long long)blockIdx.x * 32 + c;
  float s = 0.f;
  if (j < cols) {
#pragma unroll 4
    for (int r = grp; r < rows; r += 8) s += src[(size_t)r * cols + j];
  }
  part[grp][c] = s;
  __syncthreads();
  if (grp == 0 && j < cols) {
    float t = part[0][c];
#pragma unroll
    for (int i = 1; i < 8; ++i) t += part[i][c];
    dst[j] = t;
  }
}

int sum_rows(const float* src, int rows, long long cols, float* dst, cudaStream_t st) {
  const unsigned blocks = (unsigned)((cols + 31) / 32);
  sum_rows_kernel<<<blocks, 256, 0, st>>>(src, rows, cols, dst);
  return (int)cudaGetLastError();
}

// The weight products' tiling: NB columns of B per work item (128, 192 or
// 256, the one that pads the four products' columns least, the wider on a
// tie) and 128 rows of A; D of product i is [MP][NP] f32.
struct WgradPlan {
  int nb, items, fa[4], fb[4], mp[4], np[4], item0[5];
  long long total, d_off[4];
  __host__ WgradPlan(const BwdPlan& pl) {
    // (A operand, B operand) of each product: qkv, proj, fc1, fc2
    const int pa[4] = {0, 1, 2, 3}, pb[4] = {7, 6, 4, 5};
    int best = -1;
    for (int c : {128, 192, 256}) {
      int cols = 0;
      for (int i = 0; i < 4; ++i) cols += (pl.op_rows(pb[i]) + c - 1) / c * c;
      if (best < 0 || cols <= best) {
        best = cols;
        nb = c;
      }
    }
    total = 0;
    item0[0] = 0;
    for (int i = 0; i < 4; ++i) {
      fa[i] = pl.op_rows(pa[i]);
      fb[i] = pl.op_rows(pb[i]);
      mp[i] = (fa[i] + 1 + 127) / 128 * 128;
      np[i] = (fb[i] + nb - 1) / nb * nb;
      d_off[i] = total;
      total += (long long)mp[i] * np[i];
      item0[i + 1] = item0[i] + mp[i] / 128 * (np[i] / nb);
    }
    items = item0[4];
  }
  int smem_bytes() const { return kWgStages * (128 * 128 + nb * 128) + 2 * kWgStages * 8 + 1024; }
};

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
int launch_pass1(const BwdArgs& a, const BwdPlan& pl, int grid, cudaStream_t st) {
  const int smem = pl.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(swin_bwd_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  swin_bwd_kernel<NT><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_pass2(const WgradArgs& w, const WgradPlan& wp, int splits, cudaStream_t st) {
  const int smem = wp.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(swin_wgrad_kernel<NB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  swin_wgrad_kernel<NB><<<wp.items * splits, kWgThreads, smem, st>>>(w);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout numbers the wrapper holds its buffers and checks to:
// dst[0] pass-1 shared bytes, [1] NT, [2] stages per window pair, [3] ring
// slot bytes, [4] scratch bytes per warpgroup, [5] operand rows per window,
// [6] pass-2 NB, [7] work items, [8] floats of one weight-grad partial,
// [9] pass-2 shared bytes.
extern "C" int kair_swin_bwd_plan(int C, int NH, int hidden, int* dst) {
  const BwdPlan pl(C, NH, hidden);
  const WgradPlan wp(pl);
  int rows = 0;
  for (int i = 0; i < kOps; ++i) rows += pl.op_rows(i);
  dst[0] = pl.smem_bytes();
  dst[1] = pl.nt;
  dst[2] = pl.stages;
  dst[3] = pl.slot;
  dst[4] = pl.scratch;
  dst[5] = rows;
  dst[6] = wp.nb;
  dst[7] = wp.items;
  dst[8] = (int)wp.total;
  dst[9] = wp.smem_bytes();
  return 0;
}

// One call = pass 1, pass 2 and the three ordered sums, on `stream`.
// x, dy, dx (B, H, W, C) bf16; stages from pack_bwd_stages (16-byte
// aligned); bqkv (NH*96), bp (C), b1 (hidden), ln (4, C) f32; relbias
// (NH, 64, 64) f32; mask (nW, 64, 64) f32 or null. Buffers the wrapper
// sizes by kair_swin_bwd_plan with grid = min(pairs, sms): scratch [2 grid]
// [scratch bytes], ops [windows][operand rows][64] bf16 (16-byte aligned),
// part_bias [2 grid][NH][4096], part_ln [8 grid][4][C], part_w [splits]
// [partial floats] f32. Out: dw (the four products' D back to back), dln
// (4, C), dbias (NH, 64, 64), f32. C even, at most 240; H, W multiples of 8.
extern "C" int kair_swin_block_2d_bwd(
    const void* x, const void* dy, const void* stages, const void* bqkv, const void* bp,
    const void* b1, const void* ln, const void* relbias, const void* mask, void* scratch,
    void* ops, void* part_bias, void* part_ln, void* part_w, void* dx, void* dw, void* dln,
    void* dbias, int B, int H, int W, int C, int NH, int hidden, int phase, int sms,
    int splits, float scale, void* stream) {
  if (B < 0 || H < 8 || W < 8 || H % 8 || W % 8 || C < 2 || C % 2 || NH < 1 || hidden < 1 ||
      sms < 1 || splits < 1 || (long long)B * H * W >= (1LL << 31) || (size_t)stages % 16 ||
      (size_t)ops % 16 || (size_t)scratch % 16 || (size_t)x % 4 || (size_t)dy % (C % 4 ? 4 : 8) ||
      (size_t)dx % 4)
    return (int)cudaErrorInvalidValue;
  const BwdPlan pl(C, NH, hidden);
  if (!pl.fits()) return (int)cudaErrorInvalidConfiguration;
  const WgradPlan wp(pl);
  const int windows = B * (H / 8) * (W / 8);
  if (windows == 0) return (int)cudaSuccess;
  if (splits > windows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = (windows + 1) / 2;
  const int grid = pairs < sms ? pairs : sms;

  BwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.dy = static_cast<const bf16*>(dy);
  a.stages = static_cast<const bf16*>(stages);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bp = static_cast<const float*>(bp);
  a.b1 = static_cast<const float*>(b1);
  a.ln = static_cast<const float*>(ln);
  a.relbias = static_cast<const float*>(relbias);
  a.mask = static_cast<const float*>(mask);
  a.scratch = static_cast<unsigned char*>(scratch);
  bf16* op = static_cast<bf16*>(ops);
  for (int i = 0; i < kOps; ++i) {
    a.ops[i] = op;
    op += (size_t)windows * pl.op_rows(i) * 64;
  }
  a.part_bias = static_cast<float*>(part_bias);
  a.part_ln = static_cast<float*>(part_ln);
  a.dx = static_cast<bf16*>(dx);
  a.scale = scale;
  a.B = B; a.H = H; a.W = W; a.C = C; a.NH = NH; a.hidden = hidden; a.phase = phase;
  int err;
  switch (pl.nt) {
    case 64: err = launch_pass1<64>(a, pl, grid, st); break;
    case 128: err = launch_pass1<128>(a, pl, grid, st); break;
    case 184: err = launch_pass1<184>(a, pl, grid, st); break;
    default: err = launch_pass1<240>(a, pl, grid, st); break;
  }
  if (err) return err;

  WgradArgs w;
  const int pa[4] = {0, 1, 2, 3}, pb[4] = {7, 6, 4, 5};
  for (int i = 0; i < 4; ++i) {
    w.p[i].A = a.ops[pa[i]];
    w.p[i].B = a.ops[pb[i]];
    w.p[i].FA = wp.fa[i];
    w.p[i].FB = wp.fb[i];
    w.p[i].MP = wp.mp[i];
    w.p[i].NP = wp.np[i];
    w.p[i].item0 = wp.item0[i];
    w.p[i].d_off = wp.d_off[i];
  }
  w.items = wp.items;
  w.windows = windows;
  w.wps = (windows + splits - 1) / splits;
  w.total = wp.total;
  w.part = static_cast<float*>(part_w);
  switch (wp.nb) {
    case 128: err = launch_pass2<128>(w, wp, splits, st); break;
    case 192: err = launch_pass2<192>(w, wp, splits, st); break;
    default: err = launch_pass2<256>(w, wp, splits, st); break;
  }
  if (err) return err;
  err = sum_rows(w.part, splits, wp.total, static_cast<float*>(dw), st);
  if (err) return err;
  err = sum_rows(a.part_ln, 8 * grid, 4LL * C, static_cast<float*>(dln), st);
  if (err) return err;
  return sum_rows(a.part_bias, 2 * grid, (long long)NH * 4096, static_cast<float*>(dbias), st);
}

#ifdef KAIR_PROFILE
// Copies the stage counters to dst[8] (host) and zeroes them.
extern "C" int kair_swin_bwd_cycles(unsigned long long* dst) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_bwd_cycles, sizeof(g_bwd_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kMarks] = {};
  return (int)cudaMemcpyToSymbol(g_bwd_cycles, zero, sizeof(zero));
}
#endif
