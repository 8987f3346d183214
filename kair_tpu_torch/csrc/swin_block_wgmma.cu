// Fused Swin-transformer block, inference, bf16, on Hopper's warpgroup
// products (sm_90a): the entry kair_swin_block; and its attention-only mode,
// kernel B, the entry kair_window_msa.
//
// Replaces kair_tpu/ops/pallas/swin_block.py :: swin_block_pallas_2d
// (_kernel_2d :174 + _block_body :68, pl.pallas_call :701) at window 8 and
// swin_block_pallas (the window-pair _kernel :161, pl.pallas_call :843) at
// windows below 8 (ws 7 is the JPEG-CAR geometry). It computes
//
//   out = Block(roll(x, (-phase, -phase)))    in the block's own coordinates,
//   Block: x1 = x + proj(W-MSA(LN1(x)))  (rel-pos bias, optional 0/-100 shift
//          mask, softmax with the row max subtracted), out = x1 + fc2(GELU(fc1(LN2(x1))))
//
// Token t = (r, c) of window (wr, wc) is read from
// x[b, (wr*ws + r + phase) mod H, (wc*ws + c + phase) mod W]; the output
// goes to pixel (wr*ws + r, wc*ws + c). A window of N = ws*ws < 64 tokens
// is padded to 64 rows: the padded rows are zero, every key j >= N gets a
// score of -inf, and only the N real rows are stored.
//
// Kernel B, the attention-only mode (the template flag ATTN), replaces
// kair_tpu/ops/pallas/window_msa.py :: window_msa_pallas (pl.pallas_call
// :271), the unfused route's window attention on an LN1 output y:
//
//   out = roll(proj(W-MSA(roll(y, -phase))), +phase)
//
// It is the same kernel body with four differences: qkv's A operand is y
// itself (cp.async straight into the LN-output tile, no LN1 and no LN
// affine folded into the weights); the stage list ends after the last proj
// stage (the plan at HP = 0: no fc1 / fc2 stages, no LN2, no MLP);
// proj's accumulator starts at bp; and each token's bf16 result goes back to
// the wrapped pixel it was read from, so the output is un-rolled. The next
// window's y loads as soon as the last head's qkv product has read this one.
// The mode is a template parameter (four more instances to build): read at
// run time, its branches cost the block's widest instance registers, and
// the block ran 4% slower at C=240 (0.362 against 0.348 ms, PERF.md).
// At SwinIR-M width it does 305,000 FLOP per token against 720 bytes in and
// out: bound by tensor-core operations, 0.081 ms at 989 TFLOP/s for B=16,
// 128x128. (The first kernel B, a WMMA design of one 16-warp block per
// window reading its weights from L2 with no prefetch, took 2.14 ms there.)
//
// Bound on the H100: at SwinIR-M width (C=180, 6 heads, hidden 360, ws 8)
// the block does 564,480 FLOP per token against 720 bytes of activations
// in and out, above the card's ~295 FLOP/byte ridge, so it is bound by
// tensor-core operations: 0.150 ms at 989 TFLOP/s for B=16, 128x128.
//
// Design. A persistent grid, one thread block per SM, walks the B*nW
// windows two at a time (window 2t + g goes to consumer warpgroup g; at an
// odd count the last block's second warpgroup only keeps the ring's count).
// Each block has three warpgroups:
//   - a producer warpgroup, which hands most of its registers to the
//     consumers (setmaxnreg; a two-warp producer group deadlocks at
//     setmaxnreg.inc, the conv tail found): one thread streams the block's weights
//     through a ring of two bulk-copied stages (cp.async.bulk, mbarrier
//     transaction counts), one stage per K chunk of 64 of each product, in
//     the same fixed order for every window pair. pack_block_stages
//     (ops/kernels/swin_block.py) writes the stages once per set of weights,
//     already in wgmma's K-major 128-byte-swizzle layout, so a stage is one
//     copy; each stage feeds both windows, so a launch reads the weights
//     from L2 once per 128 rows (the WMMA design read them once per 64,
//     2.4 GB a SwinIR-M launch, with no prefetch);
//   - two consumer warpgroups, one 64-row window each. A window's tokens
//     arrive by cp.async while the previous window's MLP runs. Every product
//     is a wgmma with A from registers and B from shared memory:
//       qkv, per head (N = 96): A = LN1(x) by ldmatrix, B = the ring;
//       S = q k^T (N = 64): q straight from the qkv accumulator as A
//         fragments, k written to shared memory in the swizzled layout by
//         stmatrix;
//       softmax in registers (row max and sum over the quad of lanes that
//         holds a row; exp as ex2 with log2 e folded into one FMA), P
//         rounded to bf16 as A fragments;
//       O = P V (N = 32): B = v^T, written swizzled by stmatrix.trans;
//       proj (N = NT >= C): per pair of heads one 64-deep stage, each head
//         K = 32 of it, A = O from its accumulator; the f32 accumulator
//         starts at x + bp and is x1 after the last pair;
//       fc1 in hidden chunks of 64 (N = 64), exact GELU in registers, the
//         bf16 chunk as A fragments of fc2 (N = NT), which adds its K = 64
//         part into the same accumulator (x1 + b2 first).
//     LN1 and LN2 both run on that accumulator's registers (x, then x1),
//     with the row statistics over the quad of lanes that holds a row, and
//     write the LN output to shared memory. So only the LN output (64 x K),
//     the window's x tile and then one head's k and v^T (12 KB, in the x
//     tile's bytes) live in shared memory; epilogues work on the
//     accumulator registers (row 16w + lane/4 + 8(e/2), column 8j + 2(lane%4)
//     + e%2 of element 4j + e), with no staging.
// QK^T and PV are on wgmma too: k's 64-byte rows are padded to the 128-byte
// swizzle row (the upper half unused), which keeps one descriptor form.
// Registers and instruction count hold the kernel back: the accumulator
// takes NT/2 of the 240 a consumer thread gets, and every variant that kept
// more alive (two stages' products in flight, proj and fc2 waited for
// late, the score bias loaded early, A from shared memory) ran slower,
// every one that issued fewer instructions (LN on the accumulator, ex2,
// stmatrix) faster (PERF.md).
// Rounding points as in the TPU kernel: q/k/v, P, O and the MLP hidden layer
// bf16, f32 accumulation, x1 f32, the output bf16.
//
// Layouts: the stage list (one window pair; NP = ceil(NH/2) head pairs, KC
// = ceil(C/64) K chunks, HC = ceil(hidden/64) hidden chunks, 0 in kernel B):
//   for p < NP: qkv(h, k) for h in {2p, 2p+1} < NH, k < KC  (96 x 64 each)
//               proj(p)                     (NT x 64: rows 0..31 of head
//                                            2p's wp block, then 2p+1's)
//   for j < HC: fc1(j, k) for k < KC       (64 x 64), fc2(j) (NT x 64)
// each stage row n holding its 64 K values with the 16-byte unit u stored
// at u ^ (n % 8). NT = 64, 128, 184 or 240, the narrowest that holds C.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kConsumerWGs = 2;                       // one window each
constexpr int kThreads = (kConsumerWGs + 1) * 128;    // 384
constexpr int kProducerWarp = kConsumerWGs * 4;
constexpr int kSmemLimit = 232448;                    // H100 opt-in bytes per block
// Two weight stages: the producer fills one while both windows read the
// other. A deeper ring ran no faster (3 to 5 stages, PERF.md): the stream
// keeps up, and the shared memory a deeper ring takes comes out of L1, which
// serves the score-bias reads.
constexpr int kRing = 2;

static __host__ __device__ __forceinline__ int align1024(int v) {
  return (v + 1023) / 1024 * 1024;
}

// The layout that pack_block_stages and the shared memory follow; the
// wrapper's block_plan mirrors it. From the 1024-byte aligned base:
//   kRing slots | per consumer warpgroup: x tile (then k | v^T), LN output |
//   biases bqkv | bp | b1 | b2 (f32) | full and empty mbarriers
struct BlockPlan {
  int C, NH, nt, kc, np, hc, lda, slot, xs, ab, bias_floats, stages;
  __host__ __device__ BlockPlan(int c, int nh, int hp) : C(c), NH(nh) {
    nt = c <= 64 ? 64 : c <= 128 ? 128 : c <= 184 ? 184 : 240;
    kc = (c + 63) / 64;
    np = (nh + 1) / 2;
    hc = (hp + 63) / 64;
    lda = kc * 64 + 8;               // a 16-byte pad: ldmatrix rows in 8 bank groups
    slot = imax(96, nt) * 128;
    xs = align1024(imax(64 * c * 2, 3 * 4096));   // x tile, or k (8 KB) + v^T (4 KB)
    ab = align1024(64 * lda * 2);
    bias_floats = nh * 96 + c + hc * 64 + c;
    stages = nh * kc + np + hc * (kc + 1);
  }
  __host__ __device__ int wg_offset(int g) const { return kRing * slot + g * (xs + ab); }
  __host__ __device__ int bias_offset() const { return kRing * slot + kConsumerWGs * (xs + ab); }
  __host__ __device__ int bar_offset() const { return bias_offset() + align128(bias_floats * 4); }
  __host__ __device__ int smem_bytes() const { return bar_offset() + 2 * kRing * 8 + 1024; }
  __host__ __device__ bool fits() const { return C <= 240 && smem_bytes() <= kSmemLimit; }
};

struct BlockArgs {
  const bf16* x;
  bf16* out;
  const bf16* stages;
  const float* bqkv;
  const float* bp;
  const float* b1;
  const float* b2;
  const float* relbias;
  const float* mask;
  int B, H, W, C, NH, HP, phase, ws;   // HP = 0 in kernel B (b1, b2 unused)
};

// Profile build only (-DKAIR_PROFILE, the library of its own that
// kair_tpu_torch/cli/profile_swin_block.py builds), run-time mode bits in
// g_wg_mode: 1 the products only (the ring and the qkv, proj, fc1 and fc2
// wgmmas on whatever shared memory holds; no load, LN, attention core,
// GELU or store); 2 stage marks: thread 0 of consumer warpgroup 0 of every
// block adds the SM clock cycles it spent in each stage: 0 load + LN1,
// 1 waiting for a weight stage, 2 qkv, 3 attention (q/k/v epilogue, QK^T,
// softmax, PV), 4 proj, 5 LN2, 6 MLP (fc1, GELU, fc2), 7 store. Reading
// the mode at run time costs registers: the profile build runs slower than
// the normal one, so its shares are what it is for.
#ifdef KAIR_PROFILE
constexpr int kMarks = 8;
__device__ unsigned long long g_wg_cycles[kMarks];
__device__ int g_wg_mode;
#define PRODUCTS_ONLY (wg_mode & 1)
#define WPROF_DECL() long long wp_t = clock64(), wp_acc[kMarks] = {0, 0, 0, 0, 0, 0, 0, 0}
#define WPROF(i)                       \
  do {                                 \
    if (wg_mode & 2) {                 \
      const long long t_ = clock64();  \
      wp_acc[i] += t_ - wp_t;          \
      wp_t = t_;                       \
    }                                  \
  } while (0)
#define WPROF_FLUSH()                                                          \
  do {                                                                         \
    if (threadIdx.x == 0)                                                      \
      for (int i_ = 0; i_ < kMarks; ++i_)                                      \
        atomicAdd(&g_wg_cycles[i_], (unsigned long long)wp_acc[i_]);           \
  } while (0)
#else
#define PRODUCTS_ONLY false
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

template <int NT, bool ATTN>
__global__ void __launch_bounds__(kThreads, 1) swin_block_wg_kernel(BlockArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const BlockPlan pl(a.C, a.NH, a.HP);
  const int C = a.C, NH = a.NH, H = a.H, W = a.W, ws = a.ws, N = ws * ws;
  constexpr bool attn = ATTN;
  constexpr int ring = kRing;
  float* s_bqkv = reinterpret_cast<float*>(smem + pl.bias_offset());
  float* s_bp = s_bqkv + NH * 96;
  float* s_b1 = s_bp + C;
  float* s_b2 = s_b1 + pl.hc * 64;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + pl.bar_offset());
  unsigned long long* empty = full + ring;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#ifdef KAIR_PROFILE
  const int wg_mode = g_wg_mode;
#endif

  for (int i = tid; i < NH * 96; i += kThreads) s_bqkv[i] = a.bqkv[i];
  for (int i = tid; i < C; i += kThreads) {
    s_bp[i] = a.bp[i];
    if (!attn) s_b2[i] = a.b2[i];
  }
  for (int i = tid; i < pl.hc * 64; i += kThreads) s_b1[i] = i < a.HP ? a.b1[i] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWGs * 4);   // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int nwr = H / ws, nwc = W / ws;
  const int windows = a.B * nwr * nwc;
  const int pairs = (windows + 1) / 2;

  if (warp >= kProducerWarp) {
    // The block starts with 168 registers a thread (65,536 / 384, rounded
    // down to 8): 128 x 24 + 256 x 240 <= 65,536.
    setmaxnreg_dec<24>();
    if (warp == kProducerWarp && lane == 0) {
      int s = 0;
      for (int t = blockIdx.x; t < pairs; t += gridDim.x) {
        const bf16* src = a.stages;
        auto put = [&](int rows) {
          const int slot = s % ring;
          mbar_wait(&empty[slot], ((s / ring) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[slot], rows * 128);
          bulk_copy_g2s(smem + slot * pl.slot, src, rows * 128, &full[slot]);
          src += rows * 64;
          ++s;
        };
        for (int p = 0; p < pl.np; ++p) {
          for (int h = 2 * p; h < 2 * p + 2 && h < NH; ++h)
            for (int k = 0; k < pl.kc; ++k) put(96);
          put(NT);
        }
        for (int j = 0; j < pl.hc; ++j) {
          for (int k = 0; k < pl.kc; ++k) put(64);
          put(NT);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // ---- consumers: warpgroup g takes window 2t + g ------------------------------
  const int g = warp >> 2, wq = warp & 3;
  const int bar = 1 + g;                          // the warpgroup's named barrier
  unsigned char* wgb = smem + pl.wg_offset(g);
  bf16* xs = reinterpret_cast<bf16*>(wgb);        // [64][C] x tile; then k | v^T
  bf16* ab = reinterpret_cast<bf16*>(wgb + pl.xs);   // [64][lda] LN1 / LN2 output
  // k [64 tokens][128 B] and v^T [32 dims][128 B], swizzled, in the x tile
  const unsigned ring_s = smem_u32(smem), kb_s = smem_u32(wgb), vt_s = kb_s + 8192;
  const int lda = pl.lda;
  // this thread's ldmatrix row (16wq + lane % 16, at k offset 0 or 8) and
  // its accumulator rows r0, r0 + 8 and column pair q2 (+ 8j)
  const unsigned a_row =
      smem_u32(ab) + (unsigned)((wq * 16 + (lane & 15)) * lda + (lane >> 4) * 8) * 2;
  const int r0 = wq * 16 + (lane >> 2), q2 = 2 * (lane & 3);
  const float kNegInf = __int_as_float(0xff800000);
  const float* __restrict__ relbias = a.relbias;
  const float* __restrict__ maskp = a.mask;

  auto wait_full = [&](int st) -> unsigned {
    const int slot = st % ring;
    mbar_wait(&full[slot], (st / ring) & 1);
    return ring_s + slot * pl.slot;
  };
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(&empty[st % ring]);
  };

  // Window w's tokens into dst (row stride ld; the shift folded into the
  // source address), by 8- or 4-byte cp.async copies that complete while the
  // current window computes; the padded rows are zeroed. Warp wq takes
  // tokens wq, wq + 4, ...; lane i < 8 finds the map row of window row i,
  // lane 8 + i the map column of window column i, once per window. The
  // block reads x into xs; kernel B reads y straight into ab, the qkv
  // product's A operand (its K padding stays zero).
  bf16* const x_dst = attn ? ab : xs;
  const int x_ld = attn ? lda : C;
  auto fetch_x = [&](int w) {
    const int wc = w % nwc, wr = (w / nwc) % nwr, b = w / (nwc * nwr);
    const int src_rc = lane < 8 ? wrap(wr * ws + lane + a.phase, H)
                                : wrap(wc * ws + (lane & 7) + a.phase, W);
    int tr = wq / ws, tc = wq - tr * ws;          // token wq as (row, column)
    for (int tk = wq; tk < 64; tk += 4) {
      bf16* dst = x_dst + tk * x_ld;
      const int r = __shfl_sync(0xffffffffu, src_rc, tr & 7);
      const int c = __shfl_sync(0xffffffffu, src_rc, 8 + (tc & 7));
      for (tc += 4; tc >= ws; tc -= ws) ++tr;      // the token 4 further on
      if (tk < N) {
        const bf16* src = a.x + (((size_t)b * H + r) * W + c) * C;
        if (C % 4 == 0) {
          for (int i = 4 * lane; i < C; i += 128) cp_async8(dst + i, src + i, 8);
        } else {
          for (int i = 2 * lane; i < C; i += 64) cp_async4(dst + i, src + i, 4);
        }
      } else {
        for (int i = lane; i < C / 2; i += 32) reinterpret_cast<unsigned*>(dst)[i] = 0u;
      }
    }
    cp_async_commit();
  };

  float acc[NT / 2];
  int s = 0;
  // LayerNorm without affine (folded into the next product) of the
  // accumulator's rows over their C real columns into ab as bf16, the row
  // statistics taken over the quad of lanes that holds a row; ab's columns
  // past C stay zero (the K padding).
  auto layernorm_to_ab = [&]() {
    float sm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
      if (8 * j + q2 < C) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sm[e] += acc[4 * j + e];
      }
    const float mean0 = quad_sum(sm[0] + sm[1]) / C, mean1 = quad_sum(sm[2] + sm[3]) / C;
    float vs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
      if (8 * j + q2 < C) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = acc[4 * j + e] - (e < 2 ? mean0 : mean1);
          vs[e] += d * d;
        }
      }
    const float rs0 = rsqrtf(quad_sum(vs[0] + vs[1]) / C + 1e-5f);
    const float rs1 = rsqrtf(quad_sum(vs[2] + vs[3]) / C + 1e-5f);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = 8 * j + q2;
      if (col < C) {
        *reinterpret_cast<unsigned*>(ab + r0 * lda + col) =
            pack_bf16((acc[4 * j] - mean0) * rs0, (acc[4 * j + 1] - mean0) * rs0);
        *reinterpret_cast<unsigned*>(ab + (r0 + 8) * lda + col) =
            pack_bf16((acc[4 * j + 2] - mean1) * rs1, (acc[4 * j + 3] - mean1) * rs1);
      }
    }
  };
  auto add_bias = [&](const float* bias) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = 8 * j + q2;
      if (col < C) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + col);
        acc[4 * j] += bb.x;
        acc[4 * j + 1] += bb.y;
        acc[4 * j + 2] += bb.x;
        acc[4 * j + 3] += bb.y;
      }
    }
  };
  for (int i = tid & 127; i < 32 * lda; i += 128) reinterpret_cast<unsigned*>(ab)[i] = 0u;
  if (attn) named_barrier_sync(bar, 128);   // ab's zeros before y's copies
  WPROF_DECL();
  // d (N/2 f32 a thread) = ab (K chunks of 64, A fragments by ldmatrix) @
  // the next pl.kc ring stages, one stage at a time. Every product waits for
  // its wgmmas at once: keeping two stages' products in flight, deferring
  // the proj / fc2 wait into the next product, or taking A from shared
  // memory all ran slower (more live registers; PERF.md).
  auto product = [&](auto& d, int mark) {
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
  if (2 * (int)blockIdx.x + g < windows && !PRODUCTS_ONLY) fetch_x(2 * blockIdx.x + g);
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
    const int wimg = wr * nwc + wc;               // the mask's window index
    const int next = 2 * (t + gridDim.x) + g;     // this warpgroup's next window

    // ---- x (fetched during the previous window) into the accumulator, LN1 -----------
    if (PRODUCTS_ONLY) {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    } else if (attn) {
      // kernel B: y is in ab; the accumulator starts at bp
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      add_bias(s_bp);
      cp_async_wait_all();
      named_barrier_sync(bar, 128);   // every warp's tokens are in
    } else {
      cp_async_wait_all();
      named_barrier_sync(bar, 128);   // every warp's tokens are in
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int col = 8 * j + q2;
          float2 v = make_float2(0.f, 0.f);
          if (col < C)
            v = __bfloat1622float2(*reinterpret_cast<const bf162*>(xs + (r0 + 8 * hr) * C + col));
          acc[4 * j + 2 * hr] = v.x;
          acc[4 * j + 2 * hr + 1] = v.y;
        }
      layernorm_to_ab();
      add_bias(s_bp);                 // the residual stream starts at x + bp
      named_barrier_sync(bar, 128);   // ab is whole; x is dead: its bytes take k and v^T
    }
    WPROF(0);

    // ---- attention, a pair of heads at a time; proj after each pair ----------------
    for (int p = 0; p < pl.np; ++p) {
      unsigned oa[2][2][4];               // O of heads 2p, 2p+1 as A fragments
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = 2 * p + hh;
        if (h >= NH) break;
        float qkv[48];
#pragma unroll
        for (int i = 0; i < 48; ++i) qkv[i] = 0.f;
        product(qkv, 2);
        WPROF(2);
        if (PRODUCTS_ONLY) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              oa[hh][kk][i] = pack_bf16(qkv[8 * kk + 2 * i], qkv[8 * kk + 2 * i + 1]);
          continue;
        }
        // q as A fragments; k and v^T into shared memory, swizzled
        const float* bq = s_bqkv + h * 96;
        unsigned qa[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 16 * kk + 8 * (i >> 1) + q2;
            const float2 bb = *reinterpret_cast<const float2*>(bq + col);
            qa[kk][i] = pack_bf16(qkv[8 * kk + 2 * i] + bb.x, qkv[8 * kk + 2 * i + 1] + bb.y);
          }
        named_barrier_sync(bar, 128);   // the previous head's QK^T and PV are done
        // kernel B: every warp has read y for the last qkv product, so the
        // next window's y loads into ab during this head and proj
        if (attn && h == NH - 1 && next < windows) fetch_x(next);
        {
          // k and v^T by stmatrix: 8x8 tiles of (8 tokens x 8 dims), v's
          // stored transposed; lane l addresses row l % 8 of tile l / 8
          const int rr = lane & 7, mi = lane >> 3;
          float2 bk[4], bv[4];
#pragma unroll
          for (int jd = 0; jd < 4; ++jd) {
            bk[jd] = *reinterpret_cast<const float2*>(bq + 32 + 8 * jd + q2);
            bv[jd] = *reinterpret_cast<const float2*>(bq + 64 + 8 * jd + q2);
          }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            unsigned kr[4], vr[4];
#pragma unroll
            for (int jd = 0; jd < 4; ++jd) {
              kr[jd] = pack_bf16(qkv[4 * (4 + jd) + 2 * hr] + bk[jd].x,
                                 qkv[4 * (4 + jd) + 2 * hr + 1] + bk[jd].y);
              vr[jd] = pack_bf16(qkv[4 * (8 + jd) + 2 * hr] + bv[jd].x,
                                 qkv[4 * (8 + jd) + 2 * hr + 1] + bv[jd].y);
            }
            const int tb = 2 * wq + hr;                 // the tiles' 8-token block
            stmatrix_x4(kb_s + tb * 1024 + rr * 128 + ((mi ^ rr) << 4), kr);
            stmatrix_x4_trans(vt_s + mi * 1024 + rr * 128 + ((tb ^ rr) << 4), vr);
          }
        }
        fence_proxy_async();
        named_barrier_sync(bar, 128);

        // S = q k^T (q pre-scaled)
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        const unsigned long long kdesc = wgmma_desc_sw128(kb_s);
        fence_regs<32>(sc);
        wgmma_fence();
        WgmmaRS<64>::mma(sc, qa[0], kdesc, 0);
        WgmmaRS<64>::mma(sc, qa[1], kdesc + 2, 1);
        wgmma_commit();
        // the score bias (rel-pos + shift mask) loads overlap the product
        float bias[32];
        const float* rb = relbias + (size_t)h * N * N;
        const float* mk = maskp ? maskp + (size_t)wimg * N * N : nullptr;
        if (N == 64) {
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
        } else {
          // keys j >= N are padding: -inf, out of the max and the sum; padded
          // query rows take no bias and are never stored
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + 8 * (e >> 1), col = 8 * j + q2 + (e & 1);
              float v = kNegInf;
              if (col < N) {
                v = 0.f;
                if (row < N) {
                  v = __ldg(rb + row * N + col);
                  if (mk) v += __ldg(mk + row * N + col);
                }
              }
              bias[4 * j + e] = v;
            }
        }
        wgmma_wait<0>();
        fence_regs<32>(sc);
        float m4[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * j + e] += bias[4 * j + e];
            m4[e] = fmaxf(m4[e], sc[4 * j + e]);
          }
        }
        const float mx0 = quad_max(fmaxf(m4[0], m4[1])), mx1 = quad_max(fmaxf(m4[2], m4[3]));
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
        const float kLog2e = 1.4426950408889634f;
        const float ms0 = mx0 * kLog2e, ms1 = mx1 * kLog2e;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[4 * j] = ex2(fmaf(sc[4 * j], kLog2e, -ms0));
          sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], kLog2e, -ms0));
          sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], kLog2e, -ms1));
          sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], kLog2e, -ms1));
#pragma unroll
          for (int e = 0; e < 4; ++e) s4[e] += sc[4 * j + e];
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
        const unsigned long long vdesc = wgmma_desc_sw128(vt_s);
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
      }
      // proj of the pair: head 2p is K 0..31 of the stage, head 2p+1 K 32..63
      const unsigned base = wait_full(s);
      WPROF(1);
      const unsigned long long desc = wgmma_desc_sw128(base);
      fence_regs<NT / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (2 * p + hh >= NH) break;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          WgmmaRS<NT>::mma(acc, oa[hh][kk], desc + 2 * (2 * hh + kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NT / 2>(acc);
      release(s++);
      WPROF(4);
    }

    // ---- LN2 from the accumulator (x1 in f32) into ab; then x1 + b2 ---------------
    if (!attn) {
      if (!PRODUCTS_ONLY) {
        layernorm_to_ab();
        add_bias(s_b2);
      }
      named_barrier_sync(bar, 128);
      // k and v^T are dead: the next window's tokens load during the MLP
      if (next < windows && !PRODUCTS_ONLY) fetch_x(next);
    }
    WPROF(5);

    // ---- MLP in hidden chunks of 64: fc1 -> exact GELU -> fc2 into the accumulator
    // (none in kernel B: its plan has no hidden chunk) -------------------------------
    for (int j = 0; j < pl.hc; ++j) {
      float hacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
      product(hacc, 6);
      const float* bb = s_b1 + j * 64;
      unsigned ha[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 16 * kk + 8 * (i >> 1) + q2;
          const float u0 = hacc[8 * kk + 2 * i] + bb[col];
          const float u1 = hacc[8 * kk + 2 * i + 1] + bb[col + 1];
          ha[kk][i] = PRODUCTS_ONLY ? pack_bf16(u0, u1)
                                 : pack_bf16(0.5f * u0 * (1.f + erff(u0 * 0.70710678118654752f)),
                                             0.5f * u1 * (1.f + erff(u1 * 0.70710678118654752f)));
        }
      WPROF(6);
      const unsigned base = wait_full(s);
      WPROF(1);
      const unsigned long long desc = wgmma_desc_sw128(base);
      fence_regs<NT / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaRS<NT>::mma(acc, ha[kk], desc + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NT / 2>(acc);
      release(s++);
    }
    WPROF(6);

    // ---- out: the real rows, bf16 pairs from the registers; the block in its
    // own coordinates, kernel B at the wrapped pixel each token was read from -----
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row >= N || PRODUCTS_ONLY) continue;
      const int pr = wr * ws + row / ws, pc = wc * ws + row % ws;
      const size_t pix = attn ? ((size_t)b * H + wrap(pr + a.phase, H)) * W + wrap(pc + a.phase, W)
                              : ((size_t)b * H + pr) * W + pc;
      bf16* dst = a.out + pix * C;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = 8 * j + q2;
        if (col < C)
          *reinterpret_cast<unsigned*>(dst + col) =
              pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      }
    }
    named_barrier_sync(bar, 128);   // every warp is done with ab before the next window
    WPROF(7);
  }
  WPROF_FLUSH();
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

template <int NT, bool ATTN>
int launch(const BlockArgs& a, const BlockPlan& pl, cudaStream_t stream) {
  const int smem = pl.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(swin_block_wg_kernel<NT, ATTN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long windows = (long long)a.B * (a.H / a.ws) * (a.W / a.ws);
  if (windows == 0) return (int)cudaSuccess;
  const long long pairs = (windows + 1) / 2;
  const unsigned grid = (unsigned)(pairs < sm_count() ? pairs : sm_count());
  swin_block_wg_kernel<NT, ATTN><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool ATTN>
int launch_nt(const BlockArgs& a, const BlockPlan& pl, cudaStream_t stream) {
  switch (pl.nt) {
    case 64: return launch<64, ATTN>(a, pl, stream);
    case 128: return launch<128, ATTN>(a, pl, stream);
    case 184: return launch<184, ATTN>(a, pl, stream);
    default: return launch<240, ATTN>(a, pl, stream);
  }
}

}  // namespace

// x, out (B, H, W, C) bf16; stages from pack_block_stages (16-byte aligned);
// bqkv (NH*96), bp (C), b1 (HP), b2 (C) f32; relbias (NH, N, N) f32; mask
// (nW, N, N) f32 or null. C even and at most 240; ws <= 8 tiling H and W;
// x 8-byte aligned when C % 4 == 0 (else 4), out 4; B*H*W < 2^31.
extern "C" int kair_swin_block(const void* x, void* out, const void* stages, const void* bqkv,
                               const void* bp, const void* b1, const void* b2,
                               const void* relbias, const void* mask, int B, int H, int W,
                               int C, int NH, int HP, int phase, int ws, void* stream) {
  if (ws < 1 || ws > 8 || B < 0 || H < ws || W < ws || H % ws || W % ws || C < 2 || C % 2 ||
      NH < 1 || HP < 1 || (long long)B * H * W >= (1LL << 31) || (size_t)stages % 16 ||
      (size_t)x % (C % 4 ? 4 : 8) || (size_t)out % 4)
    return (int)cudaErrorInvalidValue;
  const BlockPlan pl(C, NH, HP);
  if (!pl.fits()) return (int)cudaErrorInvalidConfiguration;
  BlockArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.stages = static_cast<const bf16*>(stages);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bp = static_cast<const float*>(bp);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.relbias = static_cast<const float*>(relbias);
  a.mask = static_cast<const float*>(mask);
  a.B = B; a.H = H; a.W = W; a.C = C; a.NH = NH; a.HP = HP; a.phase = phase; a.ws = ws;
  return launch_nt<false>(a, pl, static_cast<cudaStream_t>(stream));
}

// Kernel B. y, out (B, H, W, C) bf16; stages from pack_attn_stages (the
// block's stage list up to the last proj stage, 16-byte aligned); bqkv
// (NH*96), bp (C) f32; relbias (NH, N, N) f32; mask (nW, N, N) f32 or null.
// C even and at most 240; ws <= 8 tiling H and W; y 8-byte aligned when C % 4
// == 0 (else 4), out 4; B*H*W < 2^31. Its layout is kair_swin_block_plan's
// and kair_swin_block_shared_bytes' at HP = 0.
extern "C" int kair_window_msa(const void* y, void* out, const void* stages, const void* bqkv,
                               const void* bp, const void* relbias, const void* mask, int B,
                               int H, int W, int C, int NH, int phase, int ws, void* stream) {
  if (ws < 1 || ws > 8 || B < 0 || H < ws || W < ws || H % ws || W % ws || C < 2 || C % 2 ||
      NH < 1 || (long long)B * H * W >= (1LL << 31) || (size_t)stages % 16 ||
      (size_t)y % (C % 4 ? 4 : 8) || (size_t)out % 4)
    return (int)cudaErrorInvalidValue;
  const BlockPlan pl(C, NH, 0);
  if (!pl.fits()) return (int)cudaErrorInvalidConfiguration;
  BlockArgs a;
  a.x = static_cast<const bf16*>(y);
  a.out = static_cast<bf16*>(out);
  a.stages = static_cast<const bf16*>(stages);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bp = static_cast<const float*>(bp);
  a.b1 = nullptr;
  a.b2 = nullptr;
  a.relbias = static_cast<const float*>(relbias);
  a.mask = static_cast<const float*>(mask);
  a.B = B; a.H = H; a.W = W; a.C = C; a.NH = NH; a.HP = 0; a.phase = phase; a.ws = ws;
  return launch_nt<true>(a, pl, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// At HP = 0 these two give kernel B's layout.
extern "C" int kair_swin_block_shared_bytes(int C, int NH, int HP) {
  return BlockPlan(C, NH, HP).smem_bytes();
}

// NT, K chunks, ring slots, stages per window pair and slot bytes: the
// wrapper holds its stage pack and its checks to these.
extern "C" int kair_swin_block_plan(int C, int NH, int HP, int* dst) {
  const BlockPlan pl(C, NH, HP);
  dst[0] = pl.nt;
  dst[1] = pl.kc;
  dst[2] = kRing;
  dst[3] = pl.stages;
  dst[4] = pl.slot;
  return 0;
}

#ifdef KAIR_PROFILE
// Copies the stage counters to dst[8] (host), zeroes them and sets the mode
// bits for the launches that follow.
extern "C" int kair_swin_wg_cycles(unsigned long long* dst, int mode) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_wg_cycles, sizeof(g_wg_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kMarks] = {};
  e = cudaMemcpyToSymbol(g_wg_cycles, zero, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_wg_mode, &mode, sizeof(int));
}
#endif
