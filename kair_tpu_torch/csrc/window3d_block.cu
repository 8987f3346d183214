// The 3-D window transformer blocks of VRT and RVRT, inference, bf16
// (sm_90a): VRT's TMSA mutual block on (2,8,8) windows (C entry
// kair_tmsa_block), VRT's self-attention + GEGLU block on (wd,8,8) windows,
// wd in {6, 2, 1} (kair_self6_block), and RVRT's self-only STL block on
// (2,8,8) windows with a plain GELU MLP (kair_stl2_block). All three run the
// same three passes, compiled here once for each kind of block (template
// argument KIND: kTmsa, kSelf, kStl2):
//
// kair_tmsa_block replaces kair_tpu/ops/pallas/tmsa_block.py ::
// tmsa_block_pallas (the pl.pallas_call of _impl, body _kernel):
//   out = roll(Block(roll(x, -shift)), +shift),
//   Block: h = LN1(x); s = self-MSA(h) over the window's 128 tokens (3-D
//          rel-pos bias, shift mask); m = mutual MSA(h + sine pos): frame 2's
//          queries attend frame 1's keys and values and the reverse, under the
//          frame-1 block of the shift mask, the outputs landing on the query's
//          own place in the other frame; x1 = x + proj([m | s]);
//          out = x1 + fc2(GELU(fc11(LN2(x1))) * fc12(LN2(x1)))
// with two qkv products in pass 1 and two branches (two query tiles each) in
// pass 2.
//
// kair_self6_block replaces kair_tpu/ops/pallas/self6_block.py ::
// self6_block_pallas (the pl.pallas_call of _impl, body _kernel): the second
// (self-only) TMSAG of every VRT stage (wd 6, or 2 on a 2-frame clip) and the
// RTMSA tail of stage 8 (wd 6, and wd 1 for the per-frame indep_reconsts):
//   out = roll(Block(roll(x, -shift)), +shift),
//   Block: x1 = x + proj(W-MSA(LN1(x)))   (3-D rel-pos bias, shift mask)
//          out = x1 + fc2(GELU(fc11(LN2(x1))) * fc12(LN2(x1)))
//
// kair_stl2_block replaces kair_tpu/ops/pallas/stl_block.py ::
// stl2_block_pallas (the pl.pallas_call of _impl, body _stl2_kernel): the
// STL blocks of RVRT's four propagation backbones (network_rvrt.py:337-358),
// the self block at wd 2 with KAIR's plain Mlp:
//   Block: x1 = x + proj(W-MSA(LN1(x)))   (3-D rel-pos bias, shift mask)
//          out = x1 + fc2(GELU(fc1(LN2(x1))))
// Passes 1 and 2 are the self block's; pass 3 runs one product, fc1, with
// the exact GELU in its epilogue, in place of the GEGLU's two.
//
// The passes, launched in order on one stream by each C entry:
//
//   pass 1  ln_qkv     per 64-pixel tile: LN1 (affine applied), the qkv
//                      product, and for the mutual block LN1 + sine position
//                      → the second qkv product; q/k/v to a scratch map
//   pass 2  attention  per (window, head, 64-query tile): online-softmax
//                      attention over the window's 64-key tiles, the
//                      relative-position bias gathered from the table and the
//                      0/-100 shift mask built from per-token region labels;
//                      the head's output to a second scratch map
//   pass 3  proj_mlp   per 64-pixel tile: proj + residual (f32), LN2, the
//                      MLP (GEGLU: fc11, fc12, exact GELU; plain: fc1, exact
//                      GELU), fc2 + residual → out
//
// Passes 1 and 3 are per token, so they run over the map in memory order;
// only pass 2 sees windows. The block's cyclic shift (sd, sh, sw) is folded
// into pass 2's index arithmetic: token t of window (i, j, k) is the pixel
// ((i*wd + t/64 + sd) mod D, (j*8 + t/8%8 + sh) mod H, (k*8 + t%8 + sw) mod W),
// and its output goes back to that pixel, so
//   out = roll(Block(roll(x, -shift)), +shift)
// with no roll copy and no window partition or reverse. A (6,8,8) window
// holds 384 tokens: one head's f32 scores alone would be 590 KB, and every
// head's q/k/v of a 128-token TMSA window ~147 KB, so pass 2 walks 64-key
// tiles with an online softmax (running row max and sum) and never holds
// more than a 64x64 tile of scores; the mask is built per element from the
// tokens' region labels (8 patterns), never as an (nW, N, N) tensor.
//
// Bound on the H100: at VRT-001's stage 1 the TMSA block (C=120, 6 heads,
// hidden 240) does about 496 kFLOP per token (two qkv products, self scores
// and PV over 128 keys, mutual over 64, a 2C x C proj, GEGLU) against 480
// bytes of activations in and out, ~1,030 FLOP/byte; at stage 8 the self
// block (C=180, wd 6, hidden 360) about 920 kFLOP per token against 720
// bytes, ~1,280 FLOP/byte; RVRT-001's STL2 block (C=144, hidden 288) about
// 406 kFLOP per token against 576 bytes, ~700 FLOP/byte. All are bound by
// tensor-core operations (about 12, 23 and 3.4 us for their calls at
// 1x6x64x64, 1x6x64x64 and 1x2x64x64 at 989 TFLOP/s). What the design does
// about it: every product runs on the tensor cores in bf16 with f32 sums,
// the scores never leave shared memory, and the shift costs no copy. Its
// cost: q/k/v and the attention output make one round trip through device
// memory between the passes. WMMA, not wgmma/TMA: the simple first version
// (PERF.md).
//
// Layouts (prepared on the host, ops/kernels/win3d.py): wqkv [CP][NH*96]
// bf16, per head [q|k|v] 32 columns each (head dim zero-padded, the q scale
// folded in); wp [P*NH*32][CP] bf16 with the mutual heads' rows first
// (KAIR's proj input is [mut | self]); w11, w12 [CP][HP] (w11 is fc1 of the
// plain MLP, w12 unused), w2 [HP][CP] bf16; biases and LN parameters f32;
// the rel-pos table ((2*twd-1)*15*15, NH) f32 as the model keeps it; labels
// [8][wd*64] int32. P = 2 for the mutual block (self and mutual branches), 1
// for self-only.
#include "common.cuh"

namespace kair {
namespace win3d {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                      // bf16 row padding (16 bytes)
constexpr int kSmemLimit = 232448;           // H100 opt-in bytes per block
constexpr float kNegBig = -1e30f;

// The kinds of block: which passes' branches a kernel is compiled with.
enum Kind { kTmsa, kSelf, kStl2 };
template <int K> struct KindOf {
  static constexpr bool mutual = K == kTmsa;   // the mutual branch
  static constexpr bool gated = K != kStl2;    // GEGLU, else the plain MLP
};

struct Args {
  const bf16* x;
  bf16* out;
  bf16* qkv;               // scratch [T][P*NH*96]: self heads, then mutual
  bf16* att;               // scratch [T][P*NH*32]: mutual heads, then self
  const bf16* wqkv_s;
  const float* bqkv_s;
  const bf16* wqkv_m;      // mutual only
  const float* bqkv_m;
  const float* pos;        // [64][C] sine position, mutual only
  const float* ln1;        // [2][C] scale, bias
  const float* ln2;
  const bf16* wp;
  const float* bp;
  const bf16* w11;
  const float* b11;
  const bf16* w12;         // GEGLU only
  const float* b12;
  const bf16* w2;
  const float* b2;
  const float* rel_table;  // [(2*twd-1)*225][NH]
  const int* labels;       // [8][wd*64], null when unshifted
  int B, D, H, W, C, NH, HP, wd, twd, sd, sh, sw;
};

// Shared-memory layouts of the three passes (byte offsets); the host
// mirror is ops/kernels/win3d.py::shared_bytes.
struct QkvSmem {
  int la, abuf, stage, total;
  __host__ __device__ QkvSmem(int C) {
    la = round16(C) + kPad;
    abuf = 0;                                      // [64][la] bf16
    stage = align128(64 * la * 2);
    total = stage + kWarps * kStage * 4;
  }
};

constexpr int kLQ = 32 + kPad;                   // q/k/v tile row (bf16)
constexpr int kLS = 64 + 4;                      // scores row (f32)
constexpr int kLP = 64 + kPad;                   // probabilities row (bf16)
constexpr int kLO = 32 + 4;                      // output accumulator row (f32)
struct AttnSmem {
  int q, k, v, s, p, o, total;
  __host__ __device__ AttnSmem() {
    q = 0;
    k = align128(q + 64 * kLQ * 2);
    v = align128(k + 64 * kLQ * 2);
    s = align128(v + 64 * kLQ * 2);
    p = align128(s + 64 * kLS * 4);
    o = align128(p + 64 * kLP * 2);
    total = align128(o + 64 * kLO * 4);
  }
};

struct MlpSmem {
  int lat, la, lh, at, x1, hbuf, hid, stage, total;
  __host__ __device__ MlpSmem(int C, int NH, int HP, int P) {
    lat = P * NH * 32 + kPad;
    la = round16(C) + kPad;
    lh = HP + kPad;
    at = 0;                                        // [64][lat] bf16 attention out
    x1 = align128(64 * lat * 2);                   // [64][C] f32 x + attention
    hbuf = align128(x1 + 64 * C * 4);              // [64][la] bf16 LN2 out
    hid = align128(hbuf + 64 * la * 2);            // [64][lh] bf16 GEGLU out
    stage = align128(hid + 64 * lh * 2);
    total = stage + kWarps * 2 * kStage * 4;       // two tiles per warp (GEGLU)
  }
};

// LayerNorm with its affine of 64 rows of src (global bf16, rows of C) or
// x1 (shared f32) into bf16 dst[64][ld]; columns C..CP-1 zeroed.
template <class Row>
__device__ void layernorm_affine64(Row row, int C, const float* ln, bf16* dst, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, CP = round16(C);
  for (int t = warp; t < 64; t += kWarps) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row(t, c);
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row(t, c) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
    for (int c = lane; c < CP; c += 32)
      dst[t * ld + c] = __float2bfloat16(
          c < C ? (row(t, c) - mean) * rstd * ln[c] + ln[C + c] : 0.f);
  }
}

// ---- pass 1: LN1 → qkv (and LN1 + pos → qkv_mut) ------------------------------
template <int KIND>
__device__ __forceinline__ void ln_qkv(const Args& a) {
  constexpr bool M = KindOf<KIND>::mutual;
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, CP = round16(C), NH = a.NH;
  const QkvSmem L(C);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.abuf);
  const int warp = threadIdx.x >> 5;
  float* stage = reinterpret_cast<float*>(smem + L.stage) + warp * kStage;
  const size_t p0 = (size_t)blockIdx.x * 64;
  const int QW = NH * 96, QKVW = (M ? 2 : 1) * QW;

  const bf16* x = a.x + p0 * C;
  auto xrow = [&](int t, int c) { return __bfloat162float(x[(size_t)t * C + c]); };
  layernorm_affine64(xrow, C, a.ln1, abuf, L.la);
  __syncthreads();
  bf16* qkv = a.qkv + p0 * QKVW;
  const float* bs = a.bqkv_s;
  auto self_epi = [&](int r, int c, float v) {
    qkv[(size_t)r * QKVW + c] = __float2bfloat16(v + bs[c]);
  };
  gemm_m64<kWarps>(abuf, L.la, a.wqkv_s, QW, CP / 16, QW / 16, stage, self_epi);
  if (!M) return;
  __syncthreads();
  // + sine position of the token's place in its 8x8 window (shift folded)
  for (int i = threadIdx.x; i < 64 * C; i += kThreads) {
    const int t = i / C, c = i - t * C;
    const size_t pix = p0 + t;
    const int xx = (int)(pix % a.W), yy = (int)((pix / a.W) % a.H);
    const int ry = wrap(yy - a.sh, a.H) & 7, rx = wrap(xx - a.sw, a.W) & 7;
    abuf[t * L.la + c] = __float2bfloat16(
        __bfloat162float(abuf[t * L.la + c]) + a.pos[(ry * 8 + rx) * C + c]);
  }
  __syncthreads();
  const float* bm = a.bqkv_m;
  auto mut_epi = [&](int r, int c, float v) {
    qkv[(size_t)r * QKVW + QW + c] = __float2bfloat16(v + bm[c]);
  };
  gemm_m64<kWarps>(abuf, L.la, a.wqkv_m, QW, CP / 16, QW / 16, stage, mut_epi);
}

// ---- pass 2: windowed attention, one (window, head, 64-query tile) per block ----
template <int KIND>
__device__ __forceinline__ void attention(const Args& a) {
  constexpr bool M = KindOf<KIND>::mutual;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem L;
  bf16* Q = reinterpret_cast<bf16*>(smem + L.q);
  bf16* K = reinterpret_cast<bf16*>(smem + L.k);
  bf16* V = reinterpret_cast<bf16*>(smem + L.v);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.p);
  float* O = reinterpret_cast<float*>(smem + L.o);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NH = a.NH, wd = a.wd, N = wd * 64;
  const int QT = M ? 4 : wd;               // query tiles per (window, head)
  const int nwd = a.D / wd, nwh = a.H / 8, nww = a.W / 8;
  int blk = blockIdx.x;
  const int qt = blk % QT;  blk /= QT;
  const int head = blk % NH;  blk /= NH;
  const int wk = blk % nww;  blk /= nww;
  const int wj = blk % nwh;  blk /= nwh;
  const int wi = blk % nwd;
  const int b = blk / nwd;
  const bool mut = M && qt >= 2;
  const int tile = mut ? qt - 2 : qt;             // output (and mutual key) tile
  const int qtile = mut ? 1 - tile : tile;        // the queries' tile
  const int QW = NH * 96, QKVW = (M ? 2 : 1) * QW;
  const int AW = (M ? 2 : 1) * NH * 32;
  const int qcol = (mut ? QW : 0) + head * 96;
  const int acol = (M && !mut ? NH * 32 : 0) + head * 32;
  // the window's shift-mask pattern: 4·is_last_d + 2·is_last_h + is_last_w
  const int* lab = a.labels ? a.labels + (4 * (wi == nwd - 1) + 2 * (wj == nwh - 1) +
                                          (wk == nww - 1)) * N
                            : nullptr;
  auto pixel = [&](int t) -> size_t {             // window token → map pixel
    const int d = (wi * wd + t / 64 + a.sd) % a.D;
    const int y = (wj * 8 + (t >> 3 & 7) + a.sh) % a.H;
    const int x = (wk * 8 + (t & 7) + a.sw) % a.W;
    return (((size_t)b * a.D + d) * a.H + y) * a.W + x;
  };
  // one 16-byte vector per thread: 64 tokens x 4 vectors of 8 bf16
  auto load_tile = [&](bf16* dst, int t0, int col) {
    const int t = tid >> 2, part = tid & 3;
    const uint4* src = reinterpret_cast<const uint4*>(
        a.qkv + pixel(t0 + t) * QKVW + col) + part;
    *reinterpret_cast<uint4*>(dst + t * kLQ + part * 8) = *src;
  };
  load_tile(Q, qtile * 64, qcol);
  for (int i = tid; i < 64 * kLO; i += kThreads) O[i] = 0.f;
  const int rows0 = warp * 8;                      // this warp's 8 softmax rows
  float m_run[8], l_run[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) { m_run[j] = kNegBig; l_run[j] = 0.f; }
  const int kt0 = mut ? tile : 0, kt1 = mut ? tile + 1 : wd;
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();                               // K, V, P of the last tile used
    load_tile(K, kt * 64, qcol + 32);
    load_tile(V, kt * 64, qcol + 64);
    __syncthreads();
    for (int tl = warp; tl < 16; tl += kWarps) {   // S = Q Kᵀ (q pre-scaled)
      const int m = tl >> 2, n = tl & 3;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        FragA qa;
        FragBt kb;
        wmma::load_matrix_sync(qa, Q + m * 16 * kLQ + k * 16, kLQ);
        wmma::load_matrix_sync(kb, K + n * 16 * kLQ + k * 16, kLQ);
        wmma::mma_sync(acc, qa, kb, acc);
      }
      wmma::store_matrix_sync(S + m * 16 * kLS + n * 16, acc, kLS, wmma::mem_row_major);
    }
    __syncthreads();
    // online softmax with the running row max subtracted
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = rows0 + j;
      float s[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = lane + 32 * h2;
        float v = S[i * kLS + c];
        if (mut) {
          if (lab && lab[i] != lab[c]) v -= 100.f;  // the frame-1 block of the mask
        } else {
          const int qi = qtile * 64 + i, kj = kt * 64 + c;
          const int idx = ((qi >> 6) - (kj >> 6) + a.twd - 1) * 225 +
                          ((qi >> 3 & 7) - (kj >> 3 & 7) + 7) * 15 + ((qi & 7) - (kj & 7) + 7);
          v += a.rel_table[idx * NH + head];
          if (lab && lab[qi] != lab[kj]) v -= 100.f;
        }
        s[h2] = v;
      }
      const float mx = fmaxf(m_run[j], warp_max(fmaxf(s[0], s[1])));
      const float corr = __expf(m_run[j] - mx);
      const float e0 = __expf(s[0] - mx), e1 = __expf(s[1] - mx);
      l_run[j] = l_run[j] * corr + warp_sum(e0 + e1);
      m_run[j] = mx;
      P[i * kLP + lane] = __float2bfloat16(e0);
      P[i * kLP + lane + 32] = __float2bfloat16(e1);
      O[i * kLO + lane] *= corr;
    }
    __syncthreads();
    {                                              // O += P V, one tile per warp
      const int m = warp >> 1, n = warp & 1;
      FragC acc;
      wmma::load_matrix_sync(acc, O + m * 16 * kLO + n * 16, kLO, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        FragA pa;
        FragB vb;
        wmma::load_matrix_sync(pa, P + m * 16 * kLP + k * 16, kLP);
        wmma::load_matrix_sync(vb, V + k * 16 * kLQ + n * 16, kLQ);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(O + m * 16 * kLO + n * 16, acc, kLO, wmma::mem_row_major);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {                    // the warp's rows, normalised
    const int i = rows0 + j;
    a.att[pixel(tile * 64 + i) * AW + acol + lane] =
        __float2bfloat16(O[i * kLO + lane] / l_run[j]);
  }
}

// ---- pass 3: proj + residual, LN2, GEGLU or plain MLP, fc2 + residual ----------
template <int KIND>
__device__ __forceinline__ void proj_mlp(const Args& a) {
  constexpr bool M = KindOf<KIND>::mutual;
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, CP = round16(C), NH = a.NH, HP = a.HP;
  const int PA = (M ? 2 : 1) * NH * 32;
  const MlpSmem L(C, NH, HP, M ? 2 : 1);
  bf16* at = reinterpret_cast<bf16*>(smem + L.at);
  float* x1 = reinterpret_cast<float*>(smem + L.x1);
  bf16* hbuf = reinterpret_cast<bf16*>(smem + L.hbuf);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  const int tid = threadIdx.x, warp = tid >> 5;
  float* stage = reinterpret_cast<float*>(smem + L.stage) + warp * 2 * kStage;
  const size_t p0 = (size_t)blockIdx.x * 64;

  const int nv = PA / 8;                            // 16-byte vectors per row
  for (int i = tid; i < 64 * nv; i += kThreads) {
    const int t = i / nv, part = i - t * nv;
    *reinterpret_cast<uint4*>(at + t * L.lat + part * 8) =
        reinterpret_cast<const uint4*>(a.att + (p0 + t) * PA)[part];
  }
  __syncthreads();
  const bf16* x = a.x + p0 * C;
  const float* bp = a.bp;
  auto proj_epi = [&](int r, int c, float v) {
    if (c < C) x1[r * C + c] = __bfloat162float(x[(size_t)r * C + c]) + v + bp[c];
  };
  gemm_m64<kWarps>(at, L.lat, a.wp, CP, PA / 16, CP / 16, stage, proj_epi);
  __syncthreads();
  auto x1row = [&](int t, int c) { return x1[t * C + c]; };
  layernorm_affine64(x1row, C, a.ln2, hbuf, L.la);
  __syncthreads();
  const float* b11 = a.b11;
  if constexpr (KindOf<KIND>::gated) {
    const float* b12 = a.b12;
    auto geglu_epi = [&](int r, int c, float u, float g) {
      u += b11[c];
      hid[r * L.lh + c] = __float2bfloat16(
          0.5f * u * (1.f + erff(u * 0.70710678118654752f)) * (g + b12[c]));
    };
    gemm_m64_dual<kWarps>(hbuf, L.la, a.w11, a.w12, HP, CP / 16, HP / 16, stage,
                          geglu_epi);
  } else {                                          // fc1 → exact GELU
    auto gelu_epi = [&](int r, int c, float u) {
      u += b11[c];
      hid[r * L.lh + c] = __float2bfloat16(0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
    };
    gemm_m64<kWarps>(hbuf, L.la, a.w11, HP, CP / 16, HP / 16, stage, gelu_epi);
  }
  __syncthreads();
  bf16* out = a.out + p0 * C;
  const float* b2 = a.b2;
  auto fc2_epi = [&](int r, int c, float v) {
    if (c < C) out[(size_t)r * C + c] = __float2bfloat16(x1[r * C + c] + v + b2[c]);
  };
  gemm_m64<kWarps>(hid, L.lh, a.w2, CP, HP / 16, CP / 16, stage, fc2_epi);
}


// One kernel per pass and kind of block, so a profile tells them apart.
#define KAIR_WIN3D_PASS(name, pass, KIND)                                   \
  __global__ void __launch_bounds__(kThreads) name(Args a) { pass<KIND>(a); }
KAIR_WIN3D_PASS(tmsa_ln_qkv_kernel, ln_qkv, kTmsa)
KAIR_WIN3D_PASS(tmsa_attention_kernel, attention, kTmsa)
KAIR_WIN3D_PASS(tmsa_proj_mlp_kernel, proj_mlp, kTmsa)
KAIR_WIN3D_PASS(self_ln_qkv_kernel, ln_qkv, kSelf)
KAIR_WIN3D_PASS(self_attention_kernel, attention, kSelf)
KAIR_WIN3D_PASS(self_proj_mlp_kernel, proj_mlp, kSelf)
KAIR_WIN3D_PASS(stl2_ln_qkv_kernel, ln_qkv, kStl2)
KAIR_WIN3D_PASS(stl2_attention_kernel, attention, kStl2)
KAIR_WIN3D_PASS(stl2_proj_mlp_kernel, proj_mlp, kStl2)
#undef KAIR_WIN3D_PASS

int shared_bytes(int C, int NH, int HP, int P) {
  return imax(imax(QkvSmem(C).total, AttnSmem().total), MlpSmem(C, NH, HP, P).total);
}

typedef void (*PassKernel)(Args);

// The three passes in order on one stream; returns the first CUDA error.
int launch(const Args& a, Kind kind, void* stream) {
  const bool mutual = kind == kTmsa;
  const int P = mutual ? 2 : 1;
  const int s1 = QkvSmem(a.C).total, s2 = AttnSmem().total;
  const int s3 = MlpSmem(a.C, a.NH, a.HP, P).total;
  if (imax(imax(s1, s2), s3) > kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  static const PassKernel passes[3][3] = {
      {tmsa_ln_qkv_kernel, tmsa_attention_kernel, tmsa_proj_mlp_kernel},
      {self_ln_qkv_kernel, self_attention_kernel, self_proj_mlp_kernel},
      {stl2_ln_qkv_kernel, stl2_attention_kernel, stl2_proj_mlp_kernel}};
  const PassKernel k1 = passes[kind][0], k2 = passes[kind][1], k3 = passes[kind][2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, s1)) ||
      (e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, s2)) ||
      (e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, s3)))
    return (int)e;
  const unsigned tiles = (unsigned)((size_t)a.B * a.D * a.H * a.W / 64);
  const unsigned wins = (unsigned)a.B * (a.D / a.wd) * (a.H / 8) * (a.W / 8);
  k1<<<tiles, kThreads, s1, st>>>(a);
  if ((e = cudaGetLastError())) return (int)e;
  k2<<<wins * a.NH * (mutual ? 4 : a.wd), kThreads, s2, st>>>(a);
  if ((e = cudaGetLastError())) return (int)e;
  k3<<<tiles, kThreads, s3, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace win3d
}  // namespace kair

using namespace kair;

extern "C" int kair_tmsa_block_shared_bytes(int C, int NH, int HP) {
  return win3d::shared_bytes(C, NH, HP, 2);
}

extern "C" int kair_self6_block_shared_bytes(int C, int NH, int HP) {
  return win3d::shared_bytes(C, NH, HP, 1);
}

extern "C" int kair_stl2_block_shared_bytes(int C, int NH, int HP) {
  return win3d::shared_bytes(C, NH, HP, 1);
}

// x, out, qkv scratch [T][2*NH*96], att scratch [T][2*NH*32], wqkv_s, bqkv_s,
// wqkv_m, bqkv_m, pos [64][C], ln1, ln2, wp [2*NH*32][CP], bp, w11, b11, w12,
// b12, w2, b2, rel_table [675][NH], labels [8][128] or null;
// B, D, H, W, C, NH, HP, sd, sh, sw, stream
extern "C" int kair_tmsa_block(const void* x, void* out, void* qkv, void* att,
                               const void* wqkv_s, const void* bqkv_s,
                               const void* wqkv_m, const void* bqkv_m, const void* pos,
                               const void* ln1, const void* ln2, const void* wp,
                               const void* bp, const void* w11, const void* b11,
                               const void* w12, const void* b12, const void* w2,
                               const void* b2, const void* rel_table, const void* labels,
                               int B, int D, int H, int W, int C, int NH, int HP, int sd,
                               int sh, int sw, void* stream) {
  if (D % 2 || H % 8 || W % 8) return (int)cudaErrorInvalidValue;
  win3d::Args a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.qkv = static_cast<bf16*>(qkv);
  a.att = static_cast<bf16*>(att);
  a.wqkv_s = static_cast<const bf16*>(wqkv_s);
  a.bqkv_s = static_cast<const float*>(bqkv_s);
  a.wqkv_m = static_cast<const bf16*>(wqkv_m);
  a.bqkv_m = static_cast<const float*>(bqkv_m);
  a.pos = static_cast<const float*>(pos);
  a.ln1 = static_cast<const float*>(ln1);
  a.ln2 = static_cast<const float*>(ln2);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.w11 = static_cast<const bf16*>(w11);
  a.b11 = static_cast<const float*>(b11);
  a.w12 = static_cast<const bf16*>(w12);
  a.b12 = static_cast<const float*>(b12);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.rel_table = static_cast<const float*>(rel_table);
  a.labels = static_cast<const int*>(labels);
  a.B = B; a.D = D; a.H = H; a.W = W; a.C = C; a.NH = NH; a.HP = HP;
  a.wd = 2; a.twd = 2; a.sd = sd; a.sh = sh; a.sw = sw;
  return win3d::launch(a, win3d::kTmsa, stream);
}

// x, out, qkv scratch [T][NH*96], att scratch [T][NH*32], wqkv, bqkv, ln1,
// ln2, wp [NH*32][CP], bp, w11, b11, w12, b12, w2, b2,
// rel_table [(2*twd-1)*225][NH], labels [8][wd*64] or null;
// B, D, H, W, C, NH, HP, wd, twd, sd, sh, sw, stream
extern "C" int kair_self6_block(const void* x, void* out, void* qkv, void* att,
                                const void* wqkv, const void* bqkv, const void* ln1,
                                const void* ln2, const void* wp, const void* bp,
                                const void* w11, const void* b11, const void* w12,
                                const void* b12, const void* w2, const void* b2,
                                const void* rel_table, const void* labels, int B, int D,
                                int H, int W, int C, int NH, int HP, int wd, int twd,
                                int sd, int sh, int sw, void* stream) {
  if (wd < 1 || twd < wd || D % wd || H % 8 || W % 8) return (int)cudaErrorInvalidValue;
  win3d::Args a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.qkv = static_cast<bf16*>(qkv);
  a.att = static_cast<bf16*>(att);
  a.wqkv_s = static_cast<const bf16*>(wqkv);
  a.bqkv_s = static_cast<const float*>(bqkv);
  a.wqkv_m = nullptr;
  a.bqkv_m = nullptr;
  a.pos = nullptr;
  a.ln1 = static_cast<const float*>(ln1);
  a.ln2 = static_cast<const float*>(ln2);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.w11 = static_cast<const bf16*>(w11);
  a.b11 = static_cast<const float*>(b11);
  a.w12 = static_cast<const bf16*>(w12);
  a.b12 = static_cast<const float*>(b12);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.rel_table = static_cast<const float*>(rel_table);
  a.labels = static_cast<const int*>(labels);
  a.B = B; a.D = D; a.H = H; a.W = W; a.C = C; a.NH = NH; a.HP = HP;
  a.wd = wd; a.twd = twd; a.sd = sd; a.sh = sh; a.sw = sw;
  return win3d::launch(a, win3d::kSelf, stream);
}

// x, out, qkv scratch [T][NH*96], att scratch [T][NH*32], wqkv, bqkv, ln1,
// ln2, wp [NH*32][CP], bp, w1 [CP][HP], b1, w2 [HP][CP], b2,
// rel_table [(2*twd-1)*225][NH], labels [8][128] or null;
// B, D, H, W, C, NH, HP, twd, sd, sh, sw, stream
extern "C" int kair_stl2_block(const void* x, void* out, void* qkv, void* att,
                               const void* wqkv, const void* bqkv, const void* ln1,
                               const void* ln2, const void* wp, const void* bp,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* rel_table, const void* labels,
                               int B, int D, int H, int W, int C, int NH, int HP, int twd,
                               int sd, int sh, int sw, void* stream) {
  if (twd < 2 || D % 2 || H % 8 || W % 8) return (int)cudaErrorInvalidValue;
  win3d::Args a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.qkv = static_cast<bf16*>(qkv);
  a.att = static_cast<bf16*>(att);
  a.wqkv_s = static_cast<const bf16*>(wqkv);
  a.bqkv_s = static_cast<const float*>(bqkv);
  a.wqkv_m = nullptr;
  a.bqkv_m = nullptr;
  a.pos = nullptr;
  a.ln1 = static_cast<const float*>(ln1);
  a.ln2 = static_cast<const float*>(ln2);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.w11 = static_cast<const bf16*>(w1);
  a.b11 = static_cast<const float*>(b1);
  a.w12 = nullptr;
  a.b12 = nullptr;
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.rel_table = static_cast<const float*>(rel_table);
  a.labels = static_cast<const int*>(labels);
  a.B = B; a.D = D; a.H = H; a.W = W; a.C = C; a.NH = NH; a.HP = HP;
  a.wd = 2; a.twd = twd; a.sd = sd; a.sh = sh; a.sw = sw;
  return win3d::launch(a, win3d::kStl2, stream);
}
