// Device code of the render backward, shared by the train kernel
// (render_train.cu) and the render-backward kernel (render_bwd.cu): the
// gradient buffer's layout, the dW and dX products, the per-ray shared-memory
// context, the forward with every activation stashed, and the composite ->
// heads -> MLP -> encoding backward chain. render_train.cu describes the design.

#pragma once

#include "nerf_mlp.cuh"

namespace {

constexpr int kMaxTrainS = 256;         // shared-memory limit on S of both kernels
constexpr int kRed = kThreads * 5;      // reduction scratch, floats

// The backward's copy of the weights, each stored (in, out) in bf16 with the
// same blocks and padding as Net.
struct NetT {
  const bf16* w[14];
};

// Offsets (in floats) of every block of the gradient buffer: 14 dW stored
// (in, out) with the heads' live columns only, 12 dB, then the 3 loss sums
// (the train kernel's; the render-backward kernel leaves them 0).
struct GradLayout {
  int w[14];
  int b[12];
  int sums;
  int total;
};

__host__ __device__ inline GradLayout grad_layout(int D) {
  const int H = D / 2;
  const int wsz[14] = {kPe * D, D * D, D * D, D * D, D * D, kPe * D, D * D,
                       D * D,   D * D, D,     D * D, D * H, kDe * H, H * 3};
  const int bsz[12] = {D, D, D, D, D, D, D, D, 1, D, H, 3};
  GradLayout g;
  int off = 0;
  for (int i = 0; i < 14; ++i) {
    g.w[i] = off;
    off += wsz[i];
  }
  for (int i = 0; i < 12; ++i) {
    g.b[i] = off;
    off += bsz[i];
  }
  g.sums = off;
  off += 3;
  g.total = (off + 3) / 4 * 4;   // keeps every CTA's partial buffer 16-byte aligned
  return g;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// dw[i][j] += sum_m x[m][i] * g[m][j] over the pass's 128 points: x (128, KI)
// and g (128, NJ) in shared memory, dw (KI, NJ) f32 in device memory. Warps
// take 32x64 output blocks in turn; each element is owned by one thread.
template <int KI, int NJ>
__device__ __forceinline__ void dw_accum(const bf16* x, int ldx, const bf16* g, int ldg,
                                         float* dw) {
  static_assert(KI % 32 == 0 && NJ % 64 == 0, "dW blocks are 32 x 64");
  constexpr int IB = KI / 32, JB = NJ / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r8 = lane & 7, q1 = (lane >> 3) & 1, q2 = (lane >> 4) & 1;
  for (int blk = warp; blk < IB * JB; blk += kWarps) {
    const int i0 = (blk % IB) * 32, j0 = (blk / IB) * 64;
    // the block's 32 rows x 256 bytes of dw are read after the products: ask L2
    // for them now, one lane per row, so that those reads do not wait on device memory
    {
      const float* row = dw + static_cast<size_t>(i0 + lane) * NJ + j0;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + 32));
    }
    float acc[2][8][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;
#pragma unroll 2
    for (int m0 = 0; m0 < kPts; m0 += 16) {
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)   // A = x^T: matrices (m, i), (m, i+8), (m+8, i), (m+8, i+8)
        ldmatrix_x4_trans(af[a], x + (m0 + r8 + 8 * q2) * ldx + i0 + 16 * a + 8 * q1);
#pragma unroll
      for (int b = 0; b < 4; ++b)   // B = g: matrices (m, j), (m+8, j), (m, j+8), (m+8, j+8)
        ldmatrix_x4_trans(bfr[b], g + (m0 + r8 + 8 * q1) * ldg + j0 + 16 * b + 8 * q2);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          mma_bf16_16816(acc[a][2 * b], af[a], bfr[b][0], bfr[b][1]);
          mma_bf16_16816(acc[a][2 * b + 1], af[a], bfr[b][2], bfr[b][3]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        float2* p0 = reinterpret_cast<float2*>(
            dw + static_cast<size_t>(i0 + 16 * a + gq) * NJ + j0 + 8 * b + 2 * t);
        float2* p1 = p0 + 4 * NJ;   // row + 8
        float2 v0 = *p0, v1 = *p1;
        v0.x += acc[a][b][0];
        v0.y += acc[a][b][1];
        v1.x += acc[a][b][2];
        v1.y += acc[a][b][3];
        *p0 = v0;
        *p1 = v1;
      }
  }
}

// out = bf16(mask * (g @ wt^T [+ gs (x) wd])) for the pass's 128 rows, and the
// f32 column sums of the masked result into colpart[2][N] (rows 0-63, 64-127).
// g (128, K) in shared memory; wt (N, K) in device memory, the (in, out)
// weight; xmask (128, N): the activation whose ReLU the cotangent passes
// through; gs[128], wd[N]: the density head's rank-1 term.
template <int K, int N, bool MASK, bool RANK1>
__device__ __forceinline__ void dense_bwd(const bf16* g, int ldg, const bf16* __restrict__ wt,
                                          const bf16* xmask, int ldm, const float* gs,
                                          const bf16* __restrict__ wd, bf16* out, int ldo,
                                          float* colpart) {
  constexpr int BM = 4, BN = 4;
  constexpr int MB = kPts / (16 * BM);
  constexpr int NB = N / (8 * BN);
  static_assert(MB == 2, "colpart holds two row blocks");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  for (int blk = warp; blk < MB * NB; blk += kWarps) {
    const int mb = blk % MB;
    const int m0 = mb * 16 * BM, n0 = (blk / MB) * 8 * BN;
    float acc[BM][BN][4];
#pragma unroll
    for (int i = 0; i < BM; ++i)
#pragma unroll
      for (int j = 0; j < BN; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    mma_tile<K, BM, BN>(acc, g, ldg, wt, m0, n0, gq, t);
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      float wd0 = 0.f, wd1 = 0.f;
      if (RANK1) {
        wd0 = __bfloat162float(wd[col]);
        wd1 = __bfloat162float(wd[col + 1]);
      }
      float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const int row = m0 + 16 * i + gq;
        float v0 = acc[i][j][0], v1 = acc[i][j][1], v2 = acc[i][j][2], v3 = acc[i][j][3];
        if (RANK1) {
          v0 += gs[row] * wd0;
          v1 += gs[row] * wd1;
          v2 += gs[row + 8] * wd0;
          v3 += gs[row + 8] * wd1;
        }
        if (MASK) {
          const __nv_bfloat162 xa = *reinterpret_cast<const __nv_bfloat162*>(xmask + row * ldm + col);
          const __nv_bfloat162 xb =
              *reinterpret_cast<const __nv_bfloat162*>(xmask + (row + 8) * ldm + col);
          if (!(__low2float(xa) > 0.f)) v0 = 0.f;
          if (!(__high2float(xa) > 0.f)) v1 = 0.f;
          if (!(__low2float(xb) > 0.f)) v2 = 0.f;
          if (!(__high2float(xb) > 0.f)) v3 = 0.f;
        }
        cs0 += v0 + v2;
        cs1 += v1 + v3;
        *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * ldo + col) =
            __floats2bfloat162_rn(v2, v3);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs0 += __shfl_xor_sync(0xffffffffu, cs0, off);
        cs1 += __shfl_xor_sync(0xffffffffu, cs1, off);
      }
      if (gq == 0) {
        colpart[mb * N + col] = cs0;
        colpart[mb * N + col + 1] = cs1;
      }
    }
  }
}

// db[n] += colpart[0][n] + colpart[1][n]
template <int N>
__device__ __forceinline__ void bias_accum(const float* colpart, float* db) {
  for (int n = threadIdx.x; n < N; n += kThreads) db[n] += colpart[n] + colpart[N + n];
}

// Everything a ray's backward needs, in shared memory unless noted.
struct RayCtx {
  bf16 *buf_a, *buf_b, *buf_c;   // three 128 x (D+8) activation buffers
  float* fz;      // z                                  (S)
  float* hout;    // sigmoid rgb (0-2) | raw density    (S,4)
  float* alpha;   //                                    (S)
  float* wts;     // composite weights                  (S)
  float* trans;   // transmittance                      (S)
  float* scan0;   // scan buffers                       (S)
  float* scan1;
  float* graw;    // cotangent of the raw density       (S)
  float* grgb;    // cotangent of the raw rgb           (S,4)
  float* gz;      // cotangent of z                     (S)
  float* de;      // direction encoding, bf16-valued    (32)
  float* ghsum;   // sum over samples of bf16(g_h)      (D/2)
  float* red;     // reduction scratch                  (kRed)
  float* ray;     // o | v | dir                        (9, padded to 16)
  float* rsum;    // d_o (0-2), d_v (3-5), d_dir (6-8)  (16)
  float* gsbf;    // bf16-valued graw of the pass       (128)
  bf16* stash;    // device memory: this CTA's activation stash
  float* part;    // device memory: this CTA's partial gradient buffer
};

// Derivative of the dense-lane encoding lane `e` (levels L) with respect to its
// coordinate: returns d(enc_e)/d(x_c) * g and the coordinate index c, or c = -1
// for a pad lane. x are the three coordinates the forward encoded.
__device__ __forceinline__ float enc_lane_grad(float g, const float* x, int e, int levels,
                                               int* c_out) {
  if (e < 3) {
    *c_out = e;
    return g;
  }
  int q = e - 3;
  const bool is_sin = q < 3 * levels;
  if (!is_sin) q -= 3 * levels;
  if (q >= 3 * levels) {
    *c_out = -1;
    return 0.f;
  }
  const int c = q % 3;
  const float scale = static_cast<float>(1 << (q / 3));
  const float a = x[c] * scale;
  *c_out = c;
  return (is_sin ? g * cosf(a) : -(g * sinf(a))) * scale;
}

// Composite -> heads -> MLP -> encoding backward of one ray, given the
// cotangents of its rendered rgb (g_rgb_ray[3]) and dist. With AUX it also
// takes the cotangents of the ray's per-sample weights and alpha (g_w_in,
// g_a_in: S floats each in device memory, either may be null); without AUX
// both are ignored at compile time. With DW it adds into the CTA's partial
// dW/dB; without, it forms only the dX chain (a frozen network: ctx.part is
// not touched). Leaves dz in ctx.gz and d(ray) in ctx.rsum.
template <int D, bool AUX, bool DW>
__device__ void backward_tail(const RayCtx& ctx, const Net& net, const NetT& nett,
                              const GradLayout& lay, const float* g_rgb_ray, float g_dist,
                              const float* g_w_in, const float* g_a_in, int S, int occ_softplus,
                              int head_dist_alpha, int dist_alpha, int white_bg) {
  constexpr int ldx = D + kPad;
  constexpr int H = D / 2;
  constexpr size_t slot = static_cast<size_t>(kPts) * D;
  const int tid = threadIdx.x;
  float* part = ctx.part;

  // ---- composite backward (f32) -------------------------------------------
  const float g_rgb_sum = g_rgb_ray[0] + g_rgb_ray[1] + g_rgb_ray[2];
  for (int s = tid; s < S; s += kThreads) {
    float gw = g_rgb_ray[0] * ctx.hout[4 * s] + g_rgb_ray[1] * ctx.hout[4 * s + 1] +
               g_rgb_ray[2] * ctx.hout[4 * s + 2] + g_dist * ctx.fz[s];
    if (white_bg) gw -= g_rgb_sum;
    if (AUX && g_w_in != nullptr) gw += g_w_in[s];
    ctx.graw[s] = gw;                       // g_w, until g_raw replaces it below
    ctx.scan1[s] = gw * ctx.wts[s];         // g_c = g_trans * trans
  }
  __syncthreads();
  // exclusive suffix sum of g_c, Hillis-Steele in the TPU kernel's order
  for (int s = tid; s < S; s += kThreads) ctx.scan0[s] = s + 1 < S ? ctx.scan1[s + 1] : 0.f;
  __syncthreads();
  float* src = ctx.scan0;
  float* dst = ctx.scan1;
  for (int d = 1; d < S; d <<= 1) {
    for (int s = tid; s < S; s += kThreads) dst[s] = s + d < S ? src[s] + src[s + d] : src[s];
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  // src = g_logs; dst is free and takes g_delta
  for (int s = tid; s < S; s += kThreads) {
    const float gw = ctx.graw[s], a = ctx.alpha[s], w = ctx.wts[s];
    float g_alpha = gw * ctx.trans[s] - src[s] / (1.f - a + kEps);
    if (AUX && g_a_in != nullptr) g_alpha += g_a_in[s];
    const float raw = ctx.hout[4 * s + 3];
    const float sigma = density_act(raw, occ_softplus);
    const float occ = head_dist_alpha ? sigma : 1.f - expf(-sigma);
    float g_occ = g_alpha, g_delta = 0.f;
    if (dist_alpha) {
      if (s == S - 1) {
        g_occ = 0.f;
      } else {
        const float delta = ctx.fz[s + 1] - ctx.fz[s];
        const float E = expf(-occ * delta);
        g_occ = g_alpha * delta * E;
        g_delta = g_alpha * occ * E;
      }
    }
    dst[s] = g_delta;
    const float g_sigma = head_dist_alpha ? g_occ : g_occ * (1.f - occ);
    const float g_raw =
        occ_softplus ? g_sigma * (1.f / (1.f + expf(-raw))) : (raw > 0.f ? g_sigma : 0.f);
    ctx.graw[s] = g_raw;
    ctx.gz[s] = g_dist * w;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rgb = ctx.hout[4 * s + c];
      ctx.grgb[4 * s + c] = w * g_rgb_ray[c] * rgb * (1.f - rgb);
    }
  }
  __syncthreads();
  if (dist_alpha) {
    for (int s = tid; s < S; s += kThreads)
      ctx.gz[s] = ctx.gz[s] - dst[s] + (s > 0 ? dst[s - 1] : 0.f);
  }
  if (tid < H) ctx.ghsum[tid] = 0.f;
  if (tid < 16) ctx.rsum[tid] = 0.f;
  __syncthreads();

  // ---- heads -> MLP -> encoding, pass by pass ----------------------------
  for (int p0 = 0; p0 < S; p0 += kPts) {
    bf16* st = ctx.stash + static_cast<size_t>(p0 / kPts) * stash_elems<D>();
    const float* grgb = ctx.grgb + 4 * p0;
    const float* graw = ctx.graw + p0;
    bf16* bufg = ctx.buf_a;     // current cotangent
    bf16* bufx = ctx.buf_b;     // activation read back from the stash
    bf16* bufo = ctx.buf_c;     // cotangent being produced

    // rgb head: dW[13] = h^T g_rgb, dB[11], g_h = (g_rgb wo^T) * (h > 0)
    stash_load<H>(bufx, ldx, st + 9 * slot);
    if (tid < kPts) ctx.gsbf[tid] = bf16_round(graw[tid]);
    __syncthreads();
    {
      constexpr int NG = kThreads / H;         // row groups, each of kPts / NG rows
      const int j = tid % H, grp = tid / H;
      const float wo0 = __bfloat162float(net.w[13][j]);
      const float wo1 = __bfloat162float(net.w[13][H + j]);
      const float wo2 = __bfloat162float(net.w[13][2 * H + j]);
      float cs = 0.f, csb = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
      for (int m = grp * (kPts / NG); m < (grp + 1) * (kPts / NG); ++m) {
        const float g0 = bf16_round(grgb[4 * m]), g1 = bf16_round(grgb[4 * m + 1]),
                    g2 = bf16_round(grgb[4 * m + 2]);
        const float hv = __bfloat162float(bufx[m * ldx + j]);
        float gh = g0 * wo0 + g1 * wo1 + g2 * wo2;
        if (!(hv > 0.f)) gh = 0.f;
        const bf16 ghb = __float2bfloat16_rn(gh);
        bufg[m * ldx + j] = ghb;
        cs += gh;
        csb += __bfloat162float(ghb);
        d0 += hv * g0;
        d1 += hv * g1;
        d2 += hv * g2;
      }
      float* r = ctx.red + 5 * tid;
      r[0] = cs;
      r[1] = csb;
      r[2] = d0;
      r[3] = d1;
      r[4] = d2;
      __syncthreads();
      if (tid < H) {
        float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        for (int gi = 0; gi < NG; ++gi)
#pragma unroll
          for (int k = 0; k < 5; ++k) v[k] += ctx.red[5 * (gi * H + tid) + k];
        ctx.ghsum[tid] += v[1];
        if (DW) {
          part[lay.b[10] + tid] += v[0];
          part[lay.w[13] + 3 * tid] += v[2];
          part[lay.w[13] + 3 * tid + 1] += v[3];
          part[lay.w[13] + 3 * tid + 2] += v[4];
        }
      } else if (DW && tid < H + 4) {      // dB[11] (3) and dB[8]: f32 sums over the pass
        const int c = tid - H;
        float acc = 0.f;
        if (c < 3) {
          for (int m = 0; m < kPts; ++m) acc += grgb[4 * m + c];
          part[lay.b[11] + c] += acc;
        } else {
          for (int m = 0; m < kPts; ++m) acc += graw[m];
          part[lay.b[8]] += acc;
        }
      }
      __syncthreads();
    }

    // rgb hidden: dW[11] = feat^T g_h, g_feat = g_h wrx^T (feat has no ReLU)
    stash_load<D>(bufx, ldx, st + 8 * slot);
    __syncthreads();
    if (DW) dw_accum<D, H>(bufx, ldx, bufg, ldx, part + lay.w[11]);
    dense_bwd<H, D, false, false>(bufg, ldx, nett.w[11], nullptr, 0, nullptr, nullptr, bufo, ldx,
                                  ctx.red);
    __syncthreads();
    if (DW) bias_accum<D>(ctx.red, part + lay.b[9]);
    // feature + density heads: dW[10] = x7^T g_feat, dW[9] = x7^T g_sig,
    // g7 = (g_feat wf^T + g_sig wd^T) * (x7 > 0)
    stash_load<D>(bufx, ldx, st + 7 * slot);
    __syncthreads();
    if (DW) {
      dw_accum<D, D>(bufx, ldx, bufo, ldx, part + lay.w[10]);
      for (int i = tid; i < D; i += kThreads) {
        float acc = 0.f;
        for (int m = 0; m < kPts; ++m) acc += __bfloat162float(bufx[m * ldx + i]) * ctx.gsbf[m];
        part[lay.w[9] + i] += acc;
      }
    }
    dense_bwd<D, D, true, true>(bufo, ldx, nett.w[10], bufx, ldx, ctx.gsbf, net.w[9], bufg, ldx,
                                ctx.red);
    __syncthreads();
    if (DW) bias_accum<D>(ctx.red, part + lay.b[7]);

    // trunk layers 7..1: dW = x_{l-1}^T g_l, g_{l-1} = (g_l W^T) * (x_{l-1} > 0)
#pragma unroll 1
    for (int l = 7; l >= 1; --l) {
      const int wi = l >= 5 ? l + 1 : l;
      stash_load<D>(bufx, ldx, st + static_cast<size_t>(l - 1) * slot);
      __syncthreads();
      if (DW) dw_accum<D, D>(bufx, ldx, bufg, ldx, part + lay.w[wi]);
      dense_bwd<D, D, true, false>(bufg, ldx, nett.w[wi], bufx, ldx, nullptr, nullptr, bufo, ldx,
                                   ctx.red);
      __syncthreads();
      if (DW) bias_accum<D>(ctx.red, part + lay.b[l - 1]);
      // g4 waits in the slot x4 has just vacated, for the encoding gradients
      if (l == 5) stash_store<D>(bufo, ldx, st + 4 * slot);
      bf16* tmp = bufg;
      bufg = bufo;
      bufo = tmp;
    }

    // first and skip layer, encoding side: dW[0] = pe^T g0, dW[5] = pe^T g4,
    // dpe = g0 w0^T + g4 w4pe^T, then through the encoding to o, v and z
    encode_pass(bufx, ctx.ray, ctx.fz + p0);
    __syncthreads();                              // also orders the g4 stash round trip
    stash_load<D>(bufo, ldx, st + 4 * slot);
    __syncthreads();
    if (DW) {
      dw_accum<kPe, D>(bufx, kLdPe, bufg, ldx, part + lay.w[0]);
      dw_accum<kPe, D>(bufx, kLdPe, bufo, ldx, part + lay.w[5]);
    }
    {
      const int warp = tid >> 5, lane = tid & 31;
      const int gq = lane >> 2, t = lane & 3;
      const int m0 = 16 * warp;
      float acc[1][8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[0][j][c] = 0.f;
      mma_tile<D, 1, 8>(acc, bufg, ldx, nett.w[0], m0, 0, gq, t);
      mma_tile<D, 1, 8>(acc, bufo, ldx, nett.w[5], m0, 0, gq, t);
      float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // d_o xyz, d_v xyz
      float dzr[2] = {0.f, 0.f};
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int m = m0 + gq + 8 * hrow;
        const float zz = ctx.fz[p0 + m];
        float pts[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          pts[c] = __fadd_rn(ctx.ray[c], __fmul_rn(ctx.ray[3 + c], zz));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {
            int c;
            const float tv = enc_lane_grad(acc[0][j][2 * hrow + hc], pts, 8 * j + 2 * t + hc, 10, &c);
            if (c >= 0) {
              dzr[hrow] += tv * ctx.ray[3 + c];
#pragma unroll
              for (int cc = 0; cc < 3; ++cc) {
                if (c == cc) {
                  sums[cc] += tv;
                  sums[3 + cc] += tv * zz;
                }
              }
            }
          }
        }
        dzr[hrow] += __shfl_xor_sync(0xffffffffu, dzr[hrow], 1);
        dzr[hrow] += __shfl_xor_sync(0xffffffffu, dzr[hrow], 2);
        if (t == 0) ctx.gz[p0 + m] += dzr[hrow];
      }
      block_sum<6>(sums, ctx.red);
      if (tid < 6) ctx.rsum[tid] += ctx.red[tid];
      __syncthreads();
    }
  }

  // ---- direction encoding, once per ray ---------------------------------
  // dW[12] = de^T (sum_s bf16 g_h), dde = (sum_s bf16 g_h) wrde^T -> d(dir)
  if (DW) {
    for (int e = tid; e < kDe * H; e += kThreads)
      part[lay.w[12] + e] += ctx.de[e / H] * ctx.ghsum[e % H];
  }
  if (tid < kDe) {
    const bf16* wr = nett.w[12] + static_cast<size_t>(tid) * H;
    float dde = 0.f;
    for (int j = 0; j < H; ++j) dde = fmaf(ctx.ghsum[j], __bfloat162float(wr[j]), dde);
    int c;
    ctx.red[tid] = enc_lane_grad(dde, ctx.ray + 6, tid, 4, &c);
    ctx.red[kDe + tid] = static_cast<float>(c);
  }
  __syncthreads();
  if (tid < 3) {
    float acc = 0.f;
    for (int k = 0; k < kDe; ++k)
      if (static_cast<int>(ctx.red[kDe + k]) == tid) acc += ctx.red[k];
    ctx.rsum[6 + tid] = acc;
  }
  __syncthreads();
}

// Carves a CTA's dynamic shared memory (train_smem_bytes) into `ctx`, points it
// at the CTA's stash and partial buffer in device memory, and zeroes the partial
// buffer (when there is one). *debias gets the D/2 floats of the folded direction
// bias; returns the 16 floats a kernel keeps for the ray's cotangents. Ends
// synchronised.
template <int D>
__device__ __forceinline__ float* ray_ctx_init(RayCtx& ctx, unsigned char* smem, int S,
                                               bf16* stash, float* partials, int total,
                                               float** debias) {
  ctx.buf_a = reinterpret_cast<bf16*>(smem);
  ctx.buf_b = ctx.buf_a + act_elems<D>();
  ctx.buf_c = ctx.buf_b + act_elems<D>();
  ctx.fz = reinterpret_cast<float*>(ctx.buf_c + act_elems<D>());
  ctx.hout = ctx.fz + S;
  ctx.alpha = ctx.hout + 4 * S;
  ctx.wts = ctx.alpha + S;
  ctx.trans = ctx.wts + S;
  ctx.scan0 = ctx.trans + S;
  ctx.scan1 = ctx.scan0 + S;
  ctx.graw = ctx.scan1 + S;
  ctx.grgb = ctx.graw + S;
  ctx.gz = ctx.grgb + 4 * S;
  ctx.de = ctx.gz + S;
  *debias = ctx.de + kDe;
  ctx.ghsum = *debias + D / 2;
  ctx.red = ctx.ghsum + D / 2;
  ctx.ray = ctx.red + kRed;
  ctx.rsum = ctx.ray + 16;
  ctx.gsbf = ctx.rsum + 16;
  float* cot = ctx.gsbf + kPts;
  ctx.stash = stash + static_cast<size_t>(blockIdx.x) * (S / kPts) * stash_elems<D>();
  ctx.part = partials == nullptr ? nullptr : partials + static_cast<size_t>(blockIdx.x) * total;
  const int tid = threadIdx.x;
  if (ctx.part != nullptr) {
    for (int e = tid; e < total / 4; e += kThreads)
      reinterpret_cast<float4*>(ctx.part)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < 16) cot[tid] = 0.f;
  __syncthreads();
  return cot;
}

// Forward render of ray r with every activation written to the CTA's stash:
// leaves z in ctx.fz, sigmoid rgb and the raw density in ctx.hout, alpha,
// transmittance and weights in ctx.alpha/trans/wts, and the ray's sums in
// ctx.red[0..4]: rgb (3), dist, sum of weights. Ends synchronised.
template <int D>
__device__ __forceinline__ void forward_stash(const RayCtx& ctx, const Net& net, float* debias,
                                              const float* __restrict__ rays,
                                              const float* __restrict__ z, int r, int S,
                                              int occ_softplus, int head_dist_alpha,
                                              int dist_alpha) {
  const int tid = threadIdx.x;
  if (tid < 9) ctx.ray[tid] = rays[static_cast<size_t>(r) * 9 + tid];
  for (int s = tid; s < S; s += kThreads) ctx.fz[s] = z[static_cast<size_t>(r) * S + s];
  __syncthreads();
  direction_bias<D>(net, ctx.ray, ctx.de, debias);
  for (int p0 = 0; p0 < S; p0 += kPts) {
    encode_pass(ctx.buf_c, ctx.ray, ctx.fz + p0);
    __syncthreads();
    mlp_pass<D, true>(net, ctx.buf_c, ctx.buf_a, ctx.buf_b, debias, ctx.hout + 4 * p0,
                      ctx.stash + static_cast<size_t>(p0 / kPts) * stash_elems<D>());
  }
  const float* pre = alpha_and_prefix(ctx.hout, ctx.fz, ctx.alpha, ctx.scan0, ctx.scan1, S,
                                      occ_softplus, head_dist_alpha, dist_alpha);
  float acc5[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = tid; s < S; s += kThreads) {
    const float tr = expf(pre[s]);
    const float w = ctx.alpha[s] * tr;
    ctx.trans[s] = tr;
    ctx.wts[s] = w;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rgb = 1.f / (1.f + expf(-ctx.hout[4 * s + c]));
      ctx.hout[4 * s + c] = rgb;
      acc5[c] += w * rgb;
    }
    acc5[3] += w * ctx.fz[s];
    acc5[4] += w;
  }
  block_sum<5>(acc5, ctx.red);
}

// Dynamic shared memory of one CTA of either kernel.
template <int D>
size_t train_smem_bytes(int S) {
  return sizeof(bf16) * 3 * act_elems<D>() +
         sizeof(float) * (16 * static_cast<size_t>(S) + kDe + D / 2 + D / 2 + kRed + 16 + 16 +
                          kPts + 16);
}

// grads[e] = sum over the CTAs' partial buffers, in CTA order.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ grads, int total, int n_ctas) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float acc = 0.f;
  for (int c = 0; c < n_ctas; ++c) acc += partials[static_cast<size_t>(c) * total + e];
  grads[e] = acc;
}

}  // namespace
