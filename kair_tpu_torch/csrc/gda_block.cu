// Guided deformable attention (GDA), inference, bf16 in, f32 sums (sm_90a).
//
// Replaces kair_tpu/ops/pallas/gda_block.py :: gda_fused (the pl.pallas_call
// of _fused_fwd_impl, body _gda_kernel), RVRT's alignment
// (models/rvrt.py GuidedDeformAttnPack; KAIR deform_attn_cuda_pt110.cpp:
// 64-120). For each query pixel p of frame j and head g (a head is a
// deformable group: heads == groups, every released RVRT):
//
//   for s = (n, k) in S = clip x kh x kw taps:
//     pos_s   = p + (k / kw - kh / 2, k % kw - kw / 2) + off[p, n, g, k]
//     k_s,v_s = bilinear(k / v of KV frame (n + j) % clip, group g, pos_s)
//     score_s = scale * q[p, g] . k_s
//   out[p, g] = sum_s softmax_s(score) v_s
//
// with zeros padding (a corner outside the frame reads 0, so a tap wholly
// outside scores against a zero key) and the JAX package's offset layout
// (.., clip, H, W, dg, K, 2), y first. The KV clip is read un-rotated: the
// (n + j) % clip pairing of query frame j with KV slot n is in the indices,
// so no rotated copy of k and v is made (kair_tpu/models/rvrt.py:159-166
// stacks two).
//
// Bound on the H100: at RVRT-001's call shape (q 2x64x64x288, K/V 1x2x64x
// 64x288 bf16, 12 groups of 24 channels, S = 18) one call moves about 33 MB
// (q, k, v and the output in bf16, the f32 offsets: 14.2 MB of them) and does
// about 0.85 GFLOP of f32 CUDA-core work (two bilinear samples, a dot and an
// accumulate per channel and tap): ~9.9 us of memory, ~12.7 us at the f32
// rate of 67 TFLOP/s. What the design does about it: a direct gather from
// device memory (the K/V clip, 9.4 MB, stays in L2), one warp per (pixel,
// group) with one lane per channel, so a corner's cg channels are one
// contiguous read; the tap coordinates are computed once per warp, one tap
// per lane, and handed round by shuffles; the score is a warp reduction and
// the softmax is online (running max, sum, f32 accumulator), so the sampled
// keys and values never leave registers. The TPU kernel's 2-hot matmuls,
// hat weights, MXU_MAX_HW and lane padding are TPU gather workarounds with
// no counterpart here; its samples are summed in the input type
// (preferred_element_type=dt), these in f32.
//
// Layouts: q, out [Bq][H][W][C] bf16 (Bq = B * frames); k, v
// [B][clip][H][W][C] bf16; off [Bq][clip][H][W][DG][K][2] f32.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct GdaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* off;
  bf16* out;
  int Bq, frames, clip, H, W, C, DG, kh, kw;
  float scale;
};

__global__ void __launch_bounds__(kThreads) gda_kernel(GdaArgs a) {
  const int lane = threadIdx.x & 31;
  const size_t item = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int H = a.H, W = a.W, C = a.C, G = a.DG;
  if (item >= (size_t)a.Bq * H * W * G) return;          // whole warps only
  const int g = (int)(item % G);
  const size_t pix = item / G;                            // (bq, y, x)
  const int x = (int)(pix % W), y = (int)((pix / W) % H);
  const int bq = (int)(pix / ((size_t)H * W));
  const int bk = bq / a.frames, j = bq % a.frames;
  const int cg = C / G, K = a.kh * a.kw, S = a.clip * K;
  const bool on = lane < cg;
  const float qv = on ? __bfloat162float(a.q[pix * C + g * cg + lane]) * a.scale : 0.f;

  // lane s < S: tap s's sampling position
  float fy = 0.f, fx = 0.f;
  if (lane < S) {
    const int n = lane / K, k = lane - n * K;
    const float* o = a.off +
        ((((size_t)bq * a.clip + n) * H + y) * W + x) * ((size_t)G * K * 2) + (g * K + k) * 2;
    fy = (float)(y + k / a.kw - a.kh / 2) + o[0];
    fx = (float)(x + k % a.kw - a.kw / 2) + o[1];
  }

  float m_run = -1e30f, l_run = 0.f, acc = 0.f;
  const size_t frame_px = (size_t)H * W;
  for (int s = 0; s < S; ++s) {
    const float sy = __shfl_sync(0xffffffffu, fy, s);
    const float sx = __shfl_sync(0xffffffffu, fx, s);
    const int frame = (s / K + j) % a.clip;
    const size_t base = ((size_t)bk * a.clip + frame) * frame_px;
    const bf16* kp = a.k + base * C + g * cg + lane;
    const bf16* vp = a.v + base * C + g * cg + lane;
    const float y0f = floorf(sy), x0f = floorf(sx);
    const int y0 = (int)y0f, x0 = (int)x0f;
    const float ly = sy - y0f, lx = sx - x0f;
    float ks = 0.f, vs = 0.f;
    if (on) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int yc = y0 + (c >> 1), xc = x0 + (c & 1);
        if (yc < 0 || yc >= H || xc < 0 || xc >= W) continue;
        const float wgt = ((c >> 1) ? ly : 1.f - ly) * ((c & 1) ? lx : 1.f - lx);
        const size_t at = ((size_t)yc * W + xc) * C;
        ks += wgt * __bfloat162float(kp[at]);
        vs += wgt * __bfloat162float(vp[at]);
      }
    }
    const float score = warp_sum(qv * ks);
    const float m_new = fmaxf(m_run, score);
    const float corr = __expf(m_run - m_new), p = __expf(score - m_new);
    l_run = l_run * corr + p;
    acc = acc * corr + p * vs;
    m_run = m_new;
  }
  if (on) a.out[pix * C + g * cg + lane] = __float2bfloat16(acc / l_run);
}

}  // namespace

// q [Bq][H][W][C] bf16, k, v [Bq/frames][clip][H][W][C] bf16,
// off [Bq][clip][H][W][DG][kh*kw][2] f32, out [Bq][H][W][C] bf16;
// Bq, frames, clip, H, W, C, DG, kh, kw, stream. Query b*frames + j pairs KV
// slot n with frame (n + j) % clip of KV batch b; heads == DG.
extern "C" int kair_gda(const void* q, const void* k, const void* v, const void* off,
                        void* out, int Bq, int frames, int clip, int H, int W, int C,
                        int DG, int kh, int kw, void* stream) {
  if (DG < 1 || C % DG || C / DG > 32 || clip < 1 || clip * kh * kw > 32 ||
      frames < 1 || Bq % frames || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  GdaArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.off = static_cast<const float*>(off);
  a.out = static_cast<bf16*>(out);
  a.Bq = Bq; a.frames = frames; a.clip = clip; a.H = H; a.W = W; a.C = C;
  a.DG = DG; a.kh = kh; a.kw = kw;
  a.scale = 1.f / sqrtf((float)(C / DG));
  const size_t warps = (size_t)Bq * H * W * DG;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  gda_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
