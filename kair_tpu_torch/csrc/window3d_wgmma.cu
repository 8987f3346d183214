// The 3-D window blocks of VRT and RVRT, inference, bf16, on Hopper's
// warpgroup products (sm_90a): VRT's TMSA mutual block on (2,8,8) windows
// and self block on (wd,8,8) windows, and RVRT's STL block on (2,8,8)
// windows (the self block with a plain GELU MLP); one C entry,
// kair_win3d_block, whose kind picks the block.
//
// Replaces kair_tpu/ops/pallas/tmsa_block.py :: tmsa_block_pallas
// (pl.pallas_call :253), kair_tpu/ops/pallas/self6_block.py ::
// self6_block_pallas (pl.pallas_call :203) and kair_tpu/ops/pallas/
// stl_block.py :: stl2_block_pallas (pl.pallas_call :110). They compute
//   out = roll(Block(roll(x, -shift)), +shift),
//   self block: x1 = x + proj(W-MSA(LN1(x)))  (3-D rel-pos bias, 0/-100 shift
//               mask, softmax with the row max subtracted)
//   TMSA block: h = LN1(x); s = self-MSA(h) over the window's 128 tokens;
//               m = mutual MSA(h + sine position): frame 2's queries on frame
//               1's keys and values and the reverse, under the frame-1 block
//               of the mask, each output on the query's own place in the
//               other frame; x1 = x + proj([m | s])
//   both:       out = x1 + fc2(GELU(fc11(LN2(x1))) * fc12(LN2(x1)))
//   STL block:  the self block, then out = x1 + fc2(GELU(fc1(LN2(x1))))
// with the block's cyclic shift folded into pass 2's index arithmetic: token t
// of window (i, j, k) is the pixel ((i*wd + t/64 + sd) mod D,
// (j*8 + t/8%8 + sh) mod H, (k*8 + t%8 + sw) mod W).
//
// Bound on the H100: at VRT-001's stage 1 the TMSA block (C=120, 6 heads,
// hidden 240) does 495,360 FLOP per token against 480 bytes of activations
// in and out; stage 8's self block (C=180, wd 6, hidden 360) 924,480 FLOP
// against 720 bytes: both far above the card's ~295 FLOP/byte ridge, so
// bound by tensor-core operations (≈ 0.20 ms for the TMSA block at B=8 stage
// 1 at 989 TFLOP/s).
//
// Design. Three passes, as before, since a (6,8,8) window at C=180 cannot
// hold its tokens, q/k/v and MLP in 227 KB; q/k/v and the attention output
// make one bf16 round trip through device memory between them. Every
// product is a wgmma with A from registers:
//   pass 1 (tmsa_ / self_qkv_kernel) and pass 3 (tmsa_ / self_mlp_kernel) are
//     per token: a
//     persistent grid, one block per SM of two consumer warpgroups, walks
//     64-token items in memory order, two at a time (item 2t + g to
//     warpgroup g; one at a time when the map has no more items than the
//     card has SMs, so a small map still spreads). The weights stream
//     through a ring of kRing bulk-copied stages (cp.async.bulk, mbarrier
//     transaction counts), each N rows x 64 K values, written once per set
//     of weights already in wgmma's K-major 128-byte swizzle
//     (ops/kernels/win3d.py :: pack_win3d_stages), so one stage is one copy
//     that both warpgroups read. There is no producer warp: thread 0 refills
//     a slot once every consumer warp has released it, so the block is 256
//     threads and a thread may hold 255 registers.
//       pass 1: x in the accumulator layout (the next item's rows loaded
//         while this item's products run), LN1 (affine applied) over the
//         quad of lanes that holds a row, bf16 into shared memory, A by
//         ldmatrix; per head pair one product (N = NQ: both heads' q, k, v
//         at the narrowed head widths), the qkv bias added on the
//         registers, bf16 into a staging tile by stmatrix and from there to
//         the q/k/v map in whole 16-byte pieces (stored from the registers,
//         4 bytes a lane over 8 rows, these writes took 70% of the pass);
//         the TMSA block adds the sine
//         position to the LN1 output in place and runs the mutual products;
//       pass 3: x + bp in the f32 accumulator (N = NT >= C); proj with A =
//         the attention output read straight into fragments; LN2 on the
//         accumulator into shared memory; per hidden chunk of 64 one product
//         of N = 128 (fc11 | fc12 rows), the exact-erf GEGLU on the
//         registers, the bf16 chunk as A of fc2 (N = NT), which adds into the
//         accumulator (x1 + b2 first); the output from the registers. The
//         STL block (stl2_mlp_kernel; its passes 1 and 2 are the self
//         block's) runs one product of N = 64 (fc1's rows) a hidden chunk
//         and the exact-erf GELU alone.
//   pass 2 (tmsa_ / self_attn_kernel): one warpgroup per (window, head) walks all
//     the window's 64-query tiles (up to four warpgroups an SM). K of the
//     head (wd*64 rows) arrives once by cp.async in the 32- or 64-byte
//     swizzle of its rows, v^T by plain stores, the head's row of the
//     rel-pos table and the window's region labels in shared memory (a
//     window whose labels are all equal takes no mask); S = q k^T (N = 64 keys a tile) and O += P V (N = VD) on
//     wgmma, q's fragments read from the map, the scores and the online
//     softmax (running max subtracted, ex2) in registers, P from registers
//     as the A operand of PV. The mutual branch keeps its pairing of query
//     and key tiles.
// Head widths: q and k padded to HD (16 or 32, the depth of QK^T), v to VD
// (16, 24 or 32, the N of PV); the attention output is stored unpadded.
// Rounding points: LN1 output (and LN1 + position), q/k/v, P, the attention
// output and the GEGLU hidden layer bf16; f32 sums; x1 f32; the output bf16.
//
// Layouts (ops/kernels/win3d.py mirrors Plan in win3d_plan): the q/k/v map
// [T][P*qw], qw = NH*(2HD+VD), head h's [q | k | v] at h*(2HD+VD), the mutual
// heads after the self heads; the attention map [T][P*C], the mutual heads
// first (KAIR's proj input is [mut | self]). Pass 1's stages, for each
// branch, head pair and K chunk of 64 over C: NQ rows. Pass 3's: proj per K
// chunk of P*C (NT rows), then per hidden chunk j its fc11 | fc12 K chunks
// (128 rows; the STL block's fc1, 64 rows) and fc2 (NT rows). NT is the
// narrowest width class that holds C: 96, 120 or 184 for VRT's GEGLU blocks,
// 144 or 192 (RVRT's widths) for the STL block; each class fixes HD and VD.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kThreads = 256;          // two consumer warpgroups, no producer warp
constexpr int kAttnThreads = 128;      // one warpgroup per (window, head)
constexpr int kRing = 4;               // weight stages in shared memory
constexpr int kMaxStages = 64;         // stages per item
constexpr int kMaxKcp = 4;             // proj K chunks: P*C <= 256
constexpr int kSmemLimit = 232448;     // H100 opt-in bytes per block
constexpr int kStaticSmem = kMaxStages * 8;
// the kind of block, also the C entries' kind argument
enum Kind { kSelf = 0, kTmsa = 1, kStl2 = 2 };
// The kind whose plan a pass instance follows, known when it compiles (a
// runtime kind costs the TMSA passes 4-7%): passes 1 and 2 are the self
// block's for the STL block too, which alone has the 144 and 192 classes.
template <int KIND, int NT>
__host__ __device__ constexpr int plan_kind() {
  return NT == 144 || NT == 192 ? kStl2 : KIND;
}

static __host__ __device__ __forceinline__ int align1024(int v) {
  return (v + 1023) / 1024 * 1024;
}

// The width classes: NT the accumulator width, HD the padded q/k head width,
// VD the padded v head width.
template <int NT> struct Width;
template <> struct Width<96> { static constexpr int HD = 16, VD = 16; };
template <> struct Width<120> { static constexpr int HD = 32, VD = 24; };
template <> struct Width<184> { static constexpr int HD = 32, VD = 32; };
template <> struct Width<144> { static constexpr int HD = 32, VD = 24; };
template <> struct Width<192> { static constexpr int HD = 32, VD = 32; };

// Tiling and shared-memory layout of the three passes; the host mirror is
// ops/kernels/win3d.py :: win3d_plan, held to kair_win3d_plan by chip_smoke.py.
struct Plan {
  int mutual, plain, C, NH, hidden, wd, twd;
  int nt, hd, HD, VD, nq, qw, P, qkvw, aw, kc, kcp, hc, lda;
  int slot1, slot3, stages1, stages3, ab, stg, smem1, smem2, smem3;
  __host__ __device__ Plan(int kind, int c, int nh, int hid, int wd_, int twd_)
      : mutual(kind == kTmsa), plain(kind == kStl2), C(c), NH(nh), hidden(hid),
        wd(wd_), twd(twd_) {
    nt = plain ? (c <= 144 ? 144 : 192) : c <= 96 ? 96 : c <= 120 ? 120 : 184;
    hd = nh > 0 ? c / nh : 0;
    HD = nt == 96 ? 16 : 32;
    VD = nt == 96 ? 16 : nt == 120 || nt == 144 ? 24 : 32;
    nq = 2 * (2 * HD + VD);
    qw = nh * (2 * HD + VD);
    P = mutual ? 2 : 1;
    qkvw = P * qw;
    aw = P * c;
    kc = (c + 63) / 64;
    kcp = (aw + 63) / 64;
    hc = (hid + 63) / 64;
    lda = kc * 64 + 8;                 // a 16-byte pad: ldmatrix rows in 8 bank groups
    slot1 = nq * 128;
    slot3 = imax(nt, 128) * 128;
    stages1 = P * (nh / 2) * kc;
    stages3 = kcp + hc * (kc + 1);
    ab = align1024(64 * lda * 2);
    stg = align1024(64 * (nq + 8) * 2);   // a head pair's q/k/v rows, 16-byte pad
    // ring | two LN outputs | (pass 1) two q/k/v tiles | f32 vectors | full and
    // empty barriers | align slack
    smem1 = kRing * slot1 + 2 * ab + 2 * stg + align128((qkvw + 2 * c) * 4) + 2 * kRing * 8 +
            1024;
    smem3 = kRing * slot3 + 2 * ab + align128((4 * c + 2 * hc * 64) * 4) + 2 * kRing * 8 + 1024;
    // per branch: K rows (2 HD bytes each) and v^T chunks; the table's column;
    // labels
    smem2 = P * (wd * 64 * 2 * HD + wd * VD * 128) + align128((2 * twd - 1) * 225 * 4) +
            align128(wd * 64 * 4) + 1024;
  }
  __host__ __device__ bool fits() const {
    return C >= 2 && C <= (plain ? 192 : 184) && C % 2 == 0 && NH >= 2 && NH % 2 == 0 && C % NH == 0 &&
           hd % 2 == 0 && hd <= VD && !(mutual && (nt == 184 || wd != 2 || twd != 2)) &&
           hidden >= 1 && wd >= 1 && twd >= wd && kcp <= kMaxKcp && stages1 <= kMaxStages &&
           stages3 <= kMaxStages &&
           imax(imax(smem1, smem3), smem2) + kStaticSmem <= kSmemLimit;
  }
};

struct Args {
  const bf16* x;
  bf16* out;
  bf16* qkv;               // scratch [T][qkvw]
  bf16* att;               // scratch [T][aw]
  const bf16* st1;         // pass 1's stages
  const float* bq;         // [qkvw] qkv biases in the map's order (q scaled)
  const bf16* st3;         // pass 3's stages
  const float* pos;        // [64][C] sine position, TMSA only
  const float* ln1;        // [2][C] scale, bias
  const float* ln2;
  const float* bp;         // [C]
  const float* b11;        // [hc*64]
  const float* b12;
  const float* b2;         // [C]
  const float* rel_table;  // [NH][(2*twd-1)*225]: a head's row contiguous
  const int* labels;       // [8][wd*64], null when unshifted
  int B, D, H, W, C, NH, hidden, wd, twd, sd, sh, sw, pair;
};

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

static __device__ __forceinline__ float gelu(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

// The weight ring of passes 1 and 3: stage s of the block's sequence is
// stage s % per_item of an item (table: element offset, rows), in slot
// s % kRing.
struct Ring {
  unsigned char* slots;
  int slot_bytes;
  unsigned long long* full;
  unsigned long long* empty;
  const bf16* src;
  const int2* table;
  int per_item, total;

  __device__ void issue(int s) const {
    const int2 t = table[s % per_item];
    const int k = s % kRing;
    mbar_arrive_expect_tx(&full[k], t.y * 128);
    bulk_copy_g2s(slots + k * slot_bytes, src + t.x, t.y * 128, &full[k]);
  }
  // Waits for stage s; returns its slot's shared address.
  __device__ unsigned wait(int s) const {
    mbar_wait(&full[s % kRing], (s / kRing) & 1);
    return smem_u32(slots) + (s % kRing) * slot_bytes;
  }
  // Every consumer warp releases stage s once its products are done; thread
  // 0 then waits for the other warpgroup's release and refills the slot.
  __device__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s % kRing]);
    if (threadIdx.x == 0 && s + kRing < total) {
      mbar_wait(&empty[s % kRing], (s / kRing) & 1);
      issue(s + kRing);
    }
    __syncwarp();
  }
};

// Shared set-up of passes 1 and 3: the barriers, the stage table and the
// first kRing stages; returns the block's ring. items are 64-token items.
__device__ Ring ring_setup(unsigned char* smem, int ring_bytes_off, int slot_bytes,
                           const bf16* src, int2* table, int per_item, int items, int pair) {
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + ring_bytes_off);
  const int iters = (items + pair - 1) / pair;
  const int mine = (int)blockIdx.x < iters ? (iters - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  Ring r{smem, slot_bytes, full, full + kRing, src, table, per_item, mine * per_item};
  if (threadIdx.x == 0) {
    for (int k = 0; k < kRing; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&full[kRing + k], 4 * pair);    // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kRing && s < r.total; ++s) r.issue(s);
  return r;
}

// LayerNorm with its affine of the two rows a thread holds (v[4j + 2hr + e]:
// row r0 + 8hr, column 8j + q2 + e), the row statistics over the quad of
// lanes that holds a row, bf16 into ab (columns past C keep their zeros).
template <int NT>
__device__ __forceinline__ void layernorm_to_ab(const float* v, int C, const float* ln,
                                                bf16* ab, int lda, int r0, int q2) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
    if (8 * j + q2 < C) {
      s0 += v[4 * j] + v[4 * j + 1];
      s1 += v[4 * j + 2] + v[4 * j + 3];
    }
  const float mean0 = quad_sum(s0) / C, mean1 = quad_sum(s1) / C;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
    if (8 * j + q2 < C) {
      const float d0 = v[4 * j] - mean0, d1 = v[4 * j + 1] - mean0;
      const float d2 = v[4 * j + 2] - mean1, d3 = v[4 * j + 3] - mean1;
      q0 += d0 * d0 + d1 * d1;
      q1 += d2 * d2 + d3 * d3;
    }
  const float rs0 = rsqrtf(quad_sum(q0) / C + 1e-5f), rs1 = rsqrtf(quad_sum(q1) / C + 1e-5f);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int col = 8 * j + q2;
    if (col < C) {
      const float2 g = *reinterpret_cast<const float2*>(ln + col);
      const float2 b = *reinterpret_cast<const float2*>(ln + C + col);
      *reinterpret_cast<unsigned*>(ab + r0 * lda + col) =
          pack_bf16((v[4 * j] - mean0) * rs0 * g.x + b.x, (v[4 * j + 1] - mean0) * rs0 * g.y + b.y);
      *reinterpret_cast<unsigned*>(ab + (r0 + 8) * lda + col) =
          pack_bf16((v[4 * j + 2] - mean1) * rs1 * g.x + b.x,
                    (v[4 * j + 3] - mean1) * rs1 * g.y + b.y);
    }
  }
}

// d (N/2 f32 a thread) += ab (K chunks of 64, A by ldmatrix) @ the next
// kchunks ring stages.
template <int N>
__device__ __forceinline__ void product(float* d, const Ring& ring, int& s, unsigned a_row,
                                        int kchunks) {
  for (int k = 0; k < kchunks; ++k, ++s) {
    unsigned af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a_row + (k * 64 + kk * 16) * 2, af[kk]);
    const unsigned long long desc = wgmma_desc_sw128(ring.wait(s));
    fence_regs<N / 2>(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) WgmmaRS<N>::mma(d, af[kk], desc + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<N / 2>(d);
    ring.release(s);
  }
}

// ---- pass 1: LN1 → qkv (and LN1 + position → the mutual qkv) ------------------
template <int KIND, int NT>
__device__ __forceinline__ void qkv_pass(const Args& a) {
  constexpr bool M = KIND == kTmsa;
  constexpr int HD = Width<NT>::HD, VD = Width<NT>::VD, NQ = 2 * (2 * HD + VD);
  extern __shared__ unsigned char smem_raw[];
  __shared__ int2 table[kMaxStages];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Plan pl(plan_kind<KIND, NT>(), a.C, a.NH, a.hidden, a.wd, a.twd);
  const int C = a.C, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ring_end = kRing * pl.slot1;
  float* s_b = reinterpret_cast<float*>(smem + ring_end + 2 * pl.ab + 2 * pl.stg);
  float* s_ln = s_b + pl.qkvw;
  for (int i = tid; i < pl.qkvw; i += kThreads) s_b[i] = a.bq[i];
  for (int i = tid; i < 2 * C; i += kThreads) s_ln[i] = a.ln1[i];
  for (int i = tid; i < 2 * pl.ab / 4; i += kThreads)
    reinterpret_cast<unsigned*>(smem + ring_end)[i] = 0u;
  if (tid == 0)
    for (int i = 0; i < pl.stages1; ++i) table[i] = make_int2(i * NQ * 64, NQ);
  const int items = (int)((long long)a.B * a.D * a.H * a.W / 64);
  const Ring ring =
      ring_setup(smem, ring_end + 2 * pl.ab + 2 * pl.stg + align128((pl.qkvw + 2 * C) * 4),
                 pl.slot1, a.st1, table, pl.stages1, items, a.pair);
  const int g = warp >> 2, wq = warp & 3;
  if (g >= a.pair) return;

  bf16* ab = reinterpret_cast<bf16*>(smem + ring_end + g * pl.ab);
  // the head pair's q/k/v rows, bf16, row stride NQ + 8
  bf16* stg = reinterpret_cast<bf16*>(smem + ring_end + 2 * pl.ab + g * pl.stg);
  constexpr int kLs = NQ + 8;
  const int lda = pl.lda;
  const unsigned a_row =
      smem_u32(ab) + (unsigned)((wq * 16 + (lane & 15)) * lda + (lane >> 4) * 8) * 2;
  // this lane's stmatrix row: row l % 8 of 8x8 tile l / 8 (tiles: rows 0-7 and
  // 8-15 of the warp's 16, at column 16k and 16k + 8)
  const unsigned st_row = smem_u32(stg) + (unsigned)((wq * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                                         kLs + 8 * (lane >> 4)) * 2;
  const int r0 = wq * 16 + (lane >> 2), q2 = 2 * (lane & 3);
  const int iters = (items + a.pair - 1) / a.pair;
  // an item's x in the accumulator layout, bf16 pairs: the next item's rows
  // are loaded while this item's products run
  unsigned xn[NT / 8][2];
  auto load_x = [&](int t) {
    const int item = a.pair == 2 ? 2 * t + g : t;
    if (t >= iters || item >= items) return;
    const bf16* src = a.x + ((size_t)item * 64 + r0) * C;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int col = 8 * j + q2;
        xn[j][hr] = col < C ? *reinterpret_cast<const unsigned*>(src + 8 * hr * C + col) : 0u;
      }
  };
  load_x(blockIdx.x);
  int s = 0;
  for (int t = blockIdx.x; t < iters; t += gridDim.x) {
    const int item = a.pair == 2 ? 2 * t + g : t;
    if (item >= items) {               // the ragged end: the ring's stages still pass
      for (int i = 0; i < pl.stages1; ++i, ++s) {
        ring.wait(s);
        ring.release(s);
      }
      continue;
    }
    const size_t p0 = (size_t)item * 64;
    {
      // LN1 (affine) of x → ab; a warp's ldmatrix rows are the rows it writes
      float v[NT / 2];
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&xn[j][hr]));
          v[4 * j + 2 * hr] = f.x;
          v[4 * j + 2 * hr + 1] = f.y;
        }
      layernorm_to_ab<NT>(v, C, s_ln, ab, lda, r0, q2);
    }
    load_x(t + gridDim.x);
    __syncwarp();
#pragma unroll 1
    for (int m = 0; m < (M ? 2 : 1); ++m) {
      if (m == 1) {
        // + the sine position of the token's place in its 8x8 window (the
        // shift folded in), on the bf16 LN1 output
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = r0 + 8 * hr;
          const size_t pix = p0 + row;
          const int xx = (int)(pix % a.W), yy = (int)((pix / a.W) % a.H);
          const int ry = wrap(yy - a.sh, a.H) & 7, rx = wrap(xx - a.sw, a.W) & 7;
          const float* pp = a.pos + (ry * 8 + rx) * C;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const int col = 8 * j + q2;
            if (col < C) {
              bf162* e = reinterpret_cast<bf162*>(ab + row * lda + col);
              const float2 f = __bfloat1622float2(*e);
              const float2 pv = __ldg(reinterpret_cast<const float2*>(pp + col));
              *e = __floats2bfloat162_rn(f.x + pv.x, f.y + pv.y);
            }
          }
        }
        __syncwarp();
      }
      for (int pr = 0; pr < a.NH / 2; ++pr) {
        float d[NQ / 2];
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) d[i] = 0.f;
        product<NQ>(d, ring, s, a_row, pl.kc);
        // + bias, bf16 into the staging tile by stmatrix, then the tile's rows
        // to the q/k/v map in 16-byte pieces (the pair's NQ columns of a token
        // are contiguous there)
        const int cb = m * pl.qw + pr * NQ;
        named_barrier_sync(1 + g, 128);     // the last pair's rows have left the tile
#pragma unroll
        for (int k = 0; k < NQ / 16; ++k) {
          const float2 b0 = *reinterpret_cast<const float2*>(s_b + cb + 16 * k + q2);
          const float2 b1 = *reinterpret_cast<const float2*>(s_b + cb + 16 * k + 8 + q2);
          const unsigned r[4] = {pack_bf16(d[8 * k] + b0.x, d[8 * k + 1] + b0.y),
                                 pack_bf16(d[8 * k + 2] + b0.x, d[8 * k + 3] + b0.y),
                                 pack_bf16(d[8 * k + 4] + b1.x, d[8 * k + 5] + b1.y),
                                 pack_bf16(d[8 * k + 6] + b1.x, d[8 * k + 7] + b1.y)};
          stmatrix_x4(st_row + 32 * k, r);
        }
        named_barrier_sync(1 + g, 128);
        for (int i = tid & 127; i < 64 * (NQ / 8); i += 128) {
          const int row = i / (NQ / 8), ch = i - row * (NQ / 8);
          *reinterpret_cast<uint4*>(a.qkv + (p0 + row) * pl.qkvw + cb + ch * 8) =
              *reinterpret_cast<const uint4*>(stg + row * kLs + ch * 8);
        }
      }
    }
    __syncwarp();
  }
}

// ---- pass 2: attention, one warpgroup per (window, head) -------------------------
template <int KIND, int NT>
__device__ __forceinline__ void attn_pass(const Args& a) {
  constexpr bool M = KIND == kTmsa;
  constexpr int HD = Width<NT>::HD, VD = Width<NT>::VD, HW = 2 * HD + VD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Plan pl(plan_kind<KIND, NT>(), a.C, a.NH, a.hidden, a.wd, a.twd);
  const int NH = a.NH, wd = a.wd, n = wd * 64, hd = pl.hd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int RB = 2 * HD;                    // bytes of a K row
  const int kbytes = n * RB, vbytes = VD * 128, brbytes = kbytes + wd * vbytes;
  const int ntab = (2 * a.twd - 1) * 225;
  float* tbl = reinterpret_cast<float*>(smem + pl.P * brbytes);
  int* lab_s = reinterpret_cast<int*>(smem + pl.P * brbytes + align128(ntab * 4));

  int blk = blockIdx.x;
  const int head = blk % NH;  blk /= NH;
  const int nwd = a.D / wd, nwh = a.H / 8, nww = a.W / 8;
  const int wk = blk % nww;  blk /= nww;
  const int wj = blk % nwh;  blk /= nwh;
  const int wi = blk % nwd;
  const int b = blk / nwd;
  auto pixel = [&](int t) -> size_t {             // window token → map pixel
    const int d = (wi * wd + t / 64 + a.sd) % a.D;
    const int y = (wj * 8 + (t >> 3 & 7) + a.sh) % a.H;
    const int x = (wk * 8 + (t & 7) + a.sw) % a.W;
    return (((size_t)b * a.D + d) * a.H + y) * a.W + x;
  };
  // the window's shift-mask pattern: 4·is_last_d + 2·is_last_h + is_last_w
  const int* lab = a.labels ? a.labels + (4 * (wi == nwd - 1) + 2 * (wj == nwh - 1) +
                                         (wk == nww - 1)) * n
                           : nullptr;
  // K of each branch by cp.async into swizzled rows of its own width (2 HD
  // bytes: K padded to 128-byte rows held only two blocks on an SM), v^T by
  // plain stores into [VD dims][64 keys] 128-byte swizzled chunks, one per
  // key tile
  for (int br = 0; br < pl.P; ++br) {
    unsigned char* kb = smem + br * brbytes;
    const int col = br * pl.qw + head * HW;
    for (int i = tid; i < n * (HD / 8); i += kAttnThreads) {
      const int t = i / (HD / 8), u = i % (HD / 8);
      cp_async16(kb + t * RB + ((u ^ swz_narrow<RB>(t)) << 4),
                 a.qkv + pixel(t) * pl.qkvw + col + HD + u * 8);
    }
    // v^T: a thread takes 8 dims of two neighbouring keys, one 4-byte
    // store a dim
    bf16* vt = reinterpret_cast<bf16*>(kb + kbytes);
    for (int i = tid; i < n / 2 * (VD / 8); i += kAttnThreads) {
      const int t = 2 * (i / (VD / 8)), u = i % (VD / 8);
      const uint4 r0v =
          *reinterpret_cast<const uint4*>(a.qkv + pixel(t) * pl.qkvw + col + 2 * HD + u * 8);
      const uint4 r1v =
          *reinterpret_cast<const uint4*>(a.qkv + pixel(t + 1) * pl.qkvw + col + 2 * HD + u * 8);
      const bf16* e0 = reinterpret_cast<const bf16*>(&r0v);
      const bf16* e1 = reinterpret_cast<const bf16*>(&r1v);
      const int c = t >> 6, j = t & 63;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int d = u * 8 + q;
        bf162 pr;
        pr.x = e0[q];
        pr.y = e1[q];
        *reinterpret_cast<bf162*>(
            &vt[(c * vbytes + d * 128 + (((j >> 3) ^ (d & 7)) << 4)) / 2 + (j & 7)]) = pr;
      }
    }
  }
  cp_async_commit();
  for (int i = tid; i < ntab; i += kAttnThreads) tbl[i] = a.rel_table[head * ntab + i];
  int varied = 0;                    // the window's labels differ somewhere
  for (int i = tid; i < n; i += kAttnThreads) {
    lab_s[i] = lab ? lab[i] : 0;
    varied |= lab && lab[i] != lab[0];
  }
  cp_async_wait_all();
  fence_proxy_async();
  // an interior window of a shifted block lies in one region: no mask
  const bool shifted = __syncthreads_or(varied) != 0;

  const int r0 = warp * 16 + (lane >> 2), q2 = 2 * (lane & 3);
  const float kLog2e = 1.4426950408889634f;
  const int QT = M ? 4 : wd;                // query tiles: TMSA 2 self + 2 mutual
  for (int qt = 0; qt < QT; ++qt) {
    const bool mut = M && qt >= 2;
    const int otile = mut ? qt - 2 : qt;           // output (and mutual key) tile
    const int qtile = mut ? 1 - otile : otile;     // the queries' tile
    const int br = mut ? 1 : 0;
    const int col = br * pl.qw + head * HW;
    const unsigned k_s = smem_u32(smem + br * brbytes), v_s = k_s + kbytes;
    // q of the thread's two rows as A fragments, from the map
    const int qi0 = qtile * 64 + r0, qi1 = qi0 + 8;
    const bf16* q0p = a.qkv + pixel(qi0) * pl.qkvw + col;
    const bf16* q1p = a.qkv + pixel(qi1) * pl.qkvw + col;
    unsigned qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = *reinterpret_cast<const unsigned*>(q0p + 16 * kk + q2);
      qa[kk][1] = *reinterpret_cast<const unsigned*>(q1p + 16 * kk + q2);
      qa[kk][2] = *reinterpret_cast<const unsigned*>(q0p + 16 * kk + 8 + q2);
      qa[kk][3] = *reinterpret_cast<const unsigned*>(q1p + 16 * kk + 8 + q2);
    }
    // key (kt, y, x) of score column 8j + q2 + e1 is (kt, j, q2 + e1): the
    // table index is the row's base - 225 kt - 15 j - e1
    const int tb0 = ((qi0 >> 6) + a.twd - 1) * 225 + (((qi0 >> 3) & 7) + 7) * 15 + (qi0 & 7) + 7 - q2;
    const int tb1 = ((qi1 >> 6) + a.twd - 1) * 225 + (((qi1 >> 3) & 7) + 7) * 15 + (qi1 & 7) + 7 - q2;
    const int lq0 = lab_s[mut ? r0 : qi0], lq1 = lab_s[mut ? r0 + 8 : qi1];
    float o[VD / 2];
#pragma unroll
    for (int i = 0; i < VD / 2; ++i) o[i] = 0.f;
    float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
    const int kt0 = mut ? otile : 0, kt1 = mut ? otile + 1 : wd;
    for (int kt = kt0; kt < kt1; ++kt) {
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      const unsigned long long kdesc = desc_narrow<RB>(k_s + kt * 64 * RB);
      fence_regs<32>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) WgmmaRS<64>::mma(sc, qa[kk], kdesc + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(sc);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int e1 = e & 1, hr = e >> 1;
          float v = sc[4 * j + e];
          if (!mut) v += tbl[(hr ? tb1 : tb0) - kt * 225 - 15 * j - e1];
          if (shifted && lab_s[(mut ? 0 : kt * 64) + 8 * j + q2 + e1] != (hr ? lq1 : lq0))
            v -= 100.f;
          sc[4 * j + e] = v;
          if (hr) mx1 = fmaxf(mx1, v);
          else mx0 = fmaxf(mx0, v);
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = ex2((m0 - mx0) * kLog2e), c1 = ex2((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      const float ms0 = mx0 * kLog2e, ms1 = mx1 * kLog2e;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], kLog2e, -ms0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], kLog2e, -ms0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], kLog2e, -ms1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], kLog2e, -ms1));
        s0 += sc[4 * j] + sc[4 * j + 1];
        s1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * c0 + quad_sum(s0);
      l1 = l1 * c1 + quad_sum(s1);
#pragma unroll
      for (int j = 0; j < VD / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
      unsigned pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      const unsigned long long vdesc = wgmma_desc_sw128(v_s + kt * vbytes);
      fence_regs<VD / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaRS<VD>::mma(o, pa[kk], vdesc + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<VD / 2>(o);
    }
    // the head's output, normalised, unpadded, at the output tile's pixels
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int acol = (M && !mut ? a.C : 0) + head * hd;
    bf16* d0 = a.att + pixel(otile * 64 + r0) * pl.aw + acol;
    bf16* d1 = a.att + pixel(otile * 64 + r0 + 8) * pl.aw + acol;
#pragma unroll
    for (int j = 0; j < VD / 8; ++j) {
      const int c = 8 * j + q2;
      if (c < hd) {
        *reinterpret_cast<unsigned*>(d0 + c) = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
        *reinterpret_cast<unsigned*>(d1 + c) = pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      }
    }
  }
}

// ---- pass 3: proj + residual, LN2, GEGLU, fc2 + residual ---------------------------
template <int KIND, int NT>
__device__ __forceinline__ void mlp_pass(const Args& a) {
  constexpr bool M = KIND == kTmsa, G = KIND != kStl2;   // G: the GEGLU
  extern __shared__ unsigned char smem_raw[];
  __shared__ int2 table[kMaxStages];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Plan pl(plan_kind<KIND, NT>(), a.C, a.NH, a.hidden, a.wd, a.twd);
  const int C = a.C, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ring_end = kRing * pl.slot3;
  float* s_bp = reinterpret_cast<float*>(smem + ring_end + 2 * pl.ab);
  float* s_b2 = s_bp + C;
  float* s_ln = s_b2 + C;
  float* s_b11 = s_ln + 2 * C;
  float* s_b12 = s_b11 + pl.hc * 64;
  for (int i = tid; i < C; i += kThreads) {
    s_bp[i] = a.bp[i];
    s_b2[i] = a.b2[i];
  }
  for (int i = tid; i < 2 * C; i += kThreads) s_ln[i] = a.ln2[i];
  for (int i = tid; i < pl.hc * 64; i += kThreads) {
    s_b11[i] = a.b11[i];
    if (G) s_b12[i] = a.b12[i];
  }
  for (int i = tid; i < 2 * pl.ab / 4; i += kThreads)
    reinterpret_cast<unsigned*>(smem + ring_end)[i] = 0u;
  if (tid == 0) {
    int i = 0, off = 0;
    auto add = [&](int rows) {
      table[i++] = make_int2(off, rows);
      off += rows * 64;
    };
    for (int k = 0; k < pl.kcp; ++k) add(NT);
    for (int j = 0; j < pl.hc; ++j) {
      for (int k = 0; k < pl.kc; ++k) add(G ? 128 : 64);
      add(NT);
    }
  }
  const int items = (int)((long long)a.B * a.D * a.H * a.W / 64);
  const Ring ring = ring_setup(smem, ring_end + 2 * pl.ab + align128((4 * C + 2 * pl.hc * 64) * 4),
                               pl.slot3, a.st3, table, pl.stages3, items, a.pair);
  const int g = warp >> 2, wq = warp & 3;
  if (g >= a.pair) return;

  bf16* ab = reinterpret_cast<bf16*>(smem + ring_end + g * pl.ab);
  const int lda = pl.lda;
  const unsigned a_row =
      smem_u32(ab) + (unsigned)((wq * 16 + (lane & 15)) * lda + (lane >> 4) * 8) * 2;
  const int r0 = wq * 16 + (lane >> 2), q2 = 2 * (lane & 3);
  const int iters = (items + a.pair - 1) / a.pair;
  int s = 0;
  for (int t = blockIdx.x; t < iters; t += gridDim.x) {
    const int item = a.pair == 2 ? 2 * t + g : t;
    if (item >= items) {
      for (int i = 0; i < pl.stages3; ++i, ++s) {
        ring.wait(s);
        ring.release(s);
      }
      continue;
    }
    const size_t p0 = (size_t)item * 64;
    // the residual stream starts at x + bp
    float acc[NT / 2];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int col = 8 * j + q2;
        float2 f = make_float2(0.f, 0.f);
        if (col < C) {
          f = __bfloat1622float2(
              *reinterpret_cast<const bf162*>(a.x + (p0 + r0 + 8 * hr) * C + col));
          f.x += s_bp[col];
          f.y += s_bp[col + 1];
        }
        acc[4 * j + 2 * hr] = f.x;
        acc[4 * j + 2 * hr + 1] = f.y;
      }
    // proj: A = the attention output straight into fragments (zero past P*C),
    // all of them loaded before the first stage's wait
    const bf16* at0 = a.att + (p0 + r0) * pl.aw;
    unsigned af[kMaxKcp][4][4];
#pragma unroll
    for (int k = 0; k < kMaxKcp; ++k)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k * 64 + 16 * kk + 8 * (i >> 1) + q2;
          af[k][kk][i] = col < pl.aw ? *reinterpret_cast<const unsigned*>(
                                           at0 + (i & 1) * 8 * pl.aw + col)
                                     : 0u;
        }
#pragma unroll
    for (int k = 0; k < kMaxKcp; ++k) {
      if (k >= pl.kcp) break;
      const unsigned long long desc = wgmma_desc_sw128(ring.wait(s));
      fence_regs<NT / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaRS<NT>::mma(acc, af[k][kk], desc + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NT / 2>(acc);
      ring.release(s++);
    }
    // LN2 of x1 into ab; then x1 + b2
    layernorm_to_ab<NT>(acc, C, s_ln, ab, lda, r0, q2);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = 8 * j + q2;
      if (col < C) {
        const float2 bb = *reinterpret_cast<const float2*>(s_b2 + col);
        acc[4 * j] += bb.x;
        acc[4 * j + 1] += bb.y;
        acc[4 * j + 2] += bb.x;
        acc[4 * j + 3] += bb.y;
      }
    }
    __syncwarp();
    // the MLP in hidden chunks of 64: fc11 | fc12 → GELU(u)·g (or fc1 →
    // GELU(u)) → fc2 into acc
    for (int j = 0; j < pl.hc; ++j) {
      const float* b11 = s_b11 + j * 64;
      unsigned ha[4][4];
      if constexpr (G) {
        float hq[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) hq[i] = 0.f;
        product<128>(hq, ring, s, a_row, pl.kc);
        const float* b12 = s_b12 + j * 64;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 16 * kk + 8 * (i >> 1) + q2, e = 8 * kk + 2 * i;
            ha[kk][i] = pack_bf16(gelu(hq[e] + b11[col]) * (hq[e + 32] + b12[col]),
                                  gelu(hq[e + 1] + b11[col + 1]) * (hq[e + 33] + b12[col + 1]));
          }
      } else {
        float hq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) hq[i] = 0.f;
        product<64>(hq, ring, s, a_row, pl.kc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 16 * kk + 8 * (i >> 1) + q2, e = 8 * kk + 2 * i;
            ha[kk][i] = pack_bf16(gelu(hq[e] + b11[col]), gelu(hq[e + 1] + b11[col + 1]));
          }
      }
      const unsigned long long desc = wgmma_desc_sw128(ring.wait(s));
      fence_regs<NT / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaRS<NT>::mma(acc, ha[kk], desc + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NT / 2>(acc);
      ring.release(s++);
    }
    // out, bf16 pairs from the registers
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      bf16* dst = a.out + (p0 + r0 + 8 * hr) * C;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = 8 * j + q2;
        if (col < C)
          *reinterpret_cast<unsigned*>(dst + col) =
              pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      }
    }
    __syncwarp();
  }
}

// One kernel per pass and kind of block, so a profile tells them apart.
#define KAIR_WIN3D_PASS(name, pass, KIND, threads, blocks)                   \
  template <int NT>                                                         \
  __global__ void __launch_bounds__(threads, blocks) name(Args a) {         \
    pass<KIND, NT>(a);                                                      \
  }
KAIR_WIN3D_PASS(tmsa_qkv_kernel, qkv_pass, kTmsa, kThreads, 1)
KAIR_WIN3D_PASS(tmsa_attn_kernel, attn_pass, kTmsa, kAttnThreads, 4)
KAIR_WIN3D_PASS(tmsa_mlp_kernel, mlp_pass, kTmsa, kThreads, 1)
KAIR_WIN3D_PASS(self_qkv_kernel, qkv_pass, kSelf, kThreads, 1)
KAIR_WIN3D_PASS(self_attn_kernel, attn_pass, kSelf, kAttnThreads, 4)
KAIR_WIN3D_PASS(self_mlp_kernel, mlp_pass, kSelf, kThreads, 1)
KAIR_WIN3D_PASS(stl2_mlp_kernel, mlp_pass, kStl2, kThreads, 1)
#undef KAIR_WIN3D_PASS

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

// The three passes in order on one stream; returns the first CUDA error.
template <int NT>
int launch(Args a, const Plan& pl, cudaStream_t st) {
  void (*k1)(Args) = self_qkv_kernel<NT>;
  void (*k2)(Args) = self_attn_kernel<NT>;
  void (*k3)(Args);
  if constexpr (NT == 144 || NT == 192) {    // the STL block's classes only
    k3 = stl2_mlp_kernel<NT>;
  } else {
    k3 = self_mlp_kernel<NT>;
    if constexpr (NT != 184) {         // the TMSA block takes C <= 120
      if (pl.mutual) {
        k1 = tmsa_qkv_kernel<NT>;
        k2 = tmsa_attn_kernel<NT>;
        k3 = tmsa_mlp_kernel<NT>;
      }
    }
  }
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem1)) ||
      (e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem2)) ||
      (e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem3)))
    return (int)e;
  const int items = (int)((long long)a.B * a.D * a.H * a.W / 64);
  if (items == 0) return (int)cudaSuccess;
  const int sms = sm_count();
  a.pair = items > sms ? 2 : 1;
  const int iters = (items + a.pair - 1) / a.pair;
  const unsigned grid = (unsigned)(iters < sms ? iters : sms);
  const unsigned heads =
      (unsigned)a.B * (a.D / a.wd) * (a.H / 8) * (a.W / 8) * (unsigned)a.NH;
  k1<<<grid, kThreads, pl.smem1, st>>>(a);
  if ((e = cudaGetLastError())) return (int)e;
  k2<<<heads, kAttnThreads, pl.smem2, st>>>(a);
  if ((e = cudaGetLastError())) return (int)e;
  k3<<<grid, kThreads, pl.smem3, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 1 the TMSA block (wd = twd = 2), 0 the self block, 2 the STL block
// (the self block with a plain MLP: b12 unused, may be null). x, out (B, D, H,
// W, C) bf16; qkv scratch [T][qkvw], att scratch [T][P*C] bf16; st1, st3 the
// stages from pack_win3d_stages (16-byte aligned); bq [qkvw], ln1, ln2 [2][C],
// bp [C], b11, b12 [hc*64], b2 [C], pos [64][C] (TMSA) f32; rel_table
// [NH][(2*twd-1)*225] f32 (the model's table transposed); labels [8][wd*64]
// int32 or null.
extern "C" int kair_win3d_block(int kind, const void* x, void* out, void* qkv, void* att,
                                const void* st1, const void* bq, const void* st3,
                                const void* pos, const void* ln1, const void* ln2,
                                const void* bp, const void* b11, const void* b12,
                                const void* b2, const void* rel_table, const void* labels,
                                int B, int D, int H, int W, int C, int NH, int hidden, int wd,
                                int twd, int sd, int sh, int sw, void* stream) {
  if (B < 0 || wd < 1 || D % wd || H % 8 || W % 8 || (size_t)st1 % 16 || (size_t)st3 % 16 ||
      (size_t)qkv % 16 || (size_t)x % 4 || (size_t)out % 4 || (size_t)att % 4 ||
      kind < kSelf || kind > kStl2 || (kind == kTmsa && !pos) || (kind != kStl2 && !b12) ||
      (long long)B * D * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Plan pl(kind, C, NH, hidden, wd, twd);
  if (!pl.fits()) return (int)cudaErrorInvalidConfiguration;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.qkv = static_cast<bf16*>(qkv);
  a.att = static_cast<bf16*>(att);
  a.st1 = static_cast<const bf16*>(st1);
  a.bq = static_cast<const float*>(bq);
  a.st3 = static_cast<const bf16*>(st3);
  a.pos = static_cast<const float*>(pos);
  a.ln1 = static_cast<const float*>(ln1);
  a.ln2 = static_cast<const float*>(ln2);
  a.bp = static_cast<const float*>(bp);
  a.b11 = static_cast<const float*>(b11);
  a.b12 = static_cast<const float*>(b12);
  a.b2 = static_cast<const float*>(b2);
  a.rel_table = static_cast<const float*>(rel_table);
  a.labels = static_cast<const int*>(labels);
  a.B = B; a.D = D; a.H = H; a.W = W; a.C = C; a.NH = NH; a.hidden = hidden;
  a.wd = wd; a.twd = twd; a.sd = sd; a.sh = sh; a.sw = sw; a.pair = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pl.nt) {
    case 96: return launch<96>(a, pl, s);
    case 120: return launch<120>(a, pl, s);
    case 144: return launch<144>(a, pl, s);
    case 192: return launch<192>(a, pl, s);
    default: return launch<184>(a, pl, s);
  }
}

// The plan the wrapper mirrors (win3d_plan): NT, HD, VD, qkvw, aw, kc, kcp,
// hc, ring slots, stages of passes 1 and 3, slot bytes of passes 1 and 3,
// shared memory of passes 1, 2 and 3, whether the kernels take it.
extern "C" int kair_win3d_plan(int kind, int C, int NH, int hidden, int wd, int twd,
                               int* dst) {
  const Plan pl(kind, C, NH, hidden, wd, twd);
  const int v[17] = {pl.nt,     pl.HD,     pl.VD,     pl.qkvw,    pl.aw,    pl.kc,
                     pl.kcp,    pl.hc,     kRing,     pl.stages1, pl.stages3, pl.slot1,
                     pl.slot3,  pl.smem1,  pl.smem2,  pl.smem3,   pl.fits() ? 1 : 0};
  for (int i = 0; i < 17; ++i) dst[i] = v[i];
  return 0;
}
