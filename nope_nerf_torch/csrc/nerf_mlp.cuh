// Device code shared by the render kernels (render_fwd.cu, render_train.cu):
// the packed-network layout, warp-level mma.sync bf16 tiles, the dense layer
// over a 128-point pass held in shared memory, the f32 heads and the
// dense-lane frequency encoding. Every product has bf16 operands and f32
// accumulation; see render_fwd.cu for the numerics they follow.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 128;               // points per pass: 8 m-tiles of 16 rows
constexpr int kPe = 64;                 // position encoding lanes (63 live)
constexpr int kDe = 32;                 // direction encoding lanes (27 live)
constexpr int kPad = 8;                 // bf16 row pad: conflict-free fragment loads
constexpr int kLdPe = kPe + kPad;
constexpr float kEps = 1e-6f;           // compositing epsilon (reference rendering.py:9)

static_assert(kWarps * 16 == kPts, "one m-tile of 16 rows per warp in the heads");

// Packed network, the layout of nope_nerf_torch.ops.fused_render.pack_weights.
// Every weight is stored (out, in) row-major in bf16:
//   w[0] trunk0_0 (D,64)   w[1..3] trunk0_1..3 (D,D)   w[4] trunk1_0 x-part (D,D)
//   w[5] trunk1_0 pe-part (D,64)   w[6..8] trunk1_1..3 (D,D)   w[9] density (8,D)
//   w[10] feature (D,D)   w[11] rgb_hidden x-part (D/2,D)
//   w[12] rgb_hidden dir-part (D/2,32)   w[13] rgb (8,D/2)
// Biases are f32: b[0..3] trunk0, b[4..7] trunk1, b[8] density (8), b[9] feature,
// b[10] rgb_hidden (D/2), b[11] rgb (8). Head rows/biases beyond the live ones are 0.
struct Net {
  const bf16* w[14];
  const float* b[12];
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += X[m0+16i : +16, 0:K] @ W[n0+8j : +8, 0:K]^T for one warp.
// X lives in shared memory (row stride ldx), W (N,K) in global memory.
template <int K, int BM, int BN>
__device__ __forceinline__ void mma_tile(float (&acc)[BM][BN][4], const bf16* x, int ldx,
                                         const bf16* __restrict__ w, int m0, int n0,
                                         int g, int t) {
  static_assert(K % 16 == 0, "K must be a multiple of 16");
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[BN][2];
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(
          w + static_cast<size_t>(n0 + 8 * j + g) * K + k0 + 2 * t);
      b[j][0] = __ldg(wp);
      b[j][1] = __ldg(wp + 4);  // k + 8
    }
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const bf16* xp = x + (m0 + 16 * i + g) * ldx + k0 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(xp);
      a[1] = *reinterpret_cast<const uint32_t*>(xp + 8 * ldx);
      a[2] = *reinterpret_cast<const uint32_t*>(xp + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(xp + 8 * ldx + 8);
#pragma unroll
      for (int j = 0; j < BN; ++j) mma_bf16_16816(acc[i][j], a, b[j][0], b[j][1]);
    }
  }
}

// y = act(x1 @ w1^T + [x2 @ w2^T] + bias) for the pass's 128 rows, rounded to
// bf16 into shared memory. Warps take 64x32 output blocks in turn.
template <int K1, int K2, int N, bool RELU>
__device__ __forceinline__ void dense(const bf16* x1, int ld1, const bf16* __restrict__ w1,
                                      const bf16* x2, int ld2, const bf16* __restrict__ w2,
                                      const float* bias, bf16* y, int ldy) {
  constexpr int BM = 4, BN = 4;
  constexpr int MB = kPts / (16 * BM);
  constexpr int NB = N / (8 * BN);
  static_assert(N % (8 * BN) == 0, "N must be a multiple of 32");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int blk = warp; blk < MB * NB; blk += kWarps) {
    const int m0 = (blk % MB) * 16 * BM;
    const int n0 = (blk / MB) * 8 * BN;
    float acc[BM][BN][4];
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float c0 = bias[n0 + 8 * j + 2 * t], c1 = bias[n0 + 8 * j + 2 * t + 1];
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        acc[i][j][0] = c0;
        acc[i][j][1] = c1;
        acc[i][j][2] = c0;
        acc[i][j][3] = c1;
      }
    }
    mma_tile<K1, BM, BN>(acc, x1, ld1, w1, m0, n0, g, t);
    if constexpr (K2 > 0) mma_tile<K2, BM, BN>(acc, x2, ld2, w2, m0, n0, g, t);
#pragma unroll
    for (int i = 0; i < BM; ++i) {
#pragma unroll
      for (int j = 0; j < BN; ++j) {
        float v0 = acc[i][j][0], v1 = acc[i][j][1], v2 = acc[i][j][2], v3 = acc[i][j][3];
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f);
          v3 = fmaxf(v3, 0.f);
        }
        const int row = m0 + 16 * i + g, col = n0 + 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(y + row * ldy + col) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(y + (row + 8) * ldy + col) =
            __floats2bfloat162_rn(v2, v3);
      }
    }
  }
}

// f32 head: out[row*4 + col_off + c] = (x @ w^T + bias)[row, c] for c < ncols.
template <int K>
__device__ __forceinline__ void head(const bf16* x, int ldx, const bf16* __restrict__ w,
                                     const float* __restrict__ bias, float* out, int col_off,
                                     int ncols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;
  float acc[1][1][4];
  acc[0][0][0] = bias[2 * t];
  acc[0][0][1] = bias[2 * t + 1];
  acc[0][0][2] = acc[0][0][0];
  acc[0][0][3] = acc[0][0][1];
  mma_tile<K, 1, 1>(acc, x, ldx, w, m0, 0, g, t);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 2 * t + h;
    if (c < ncols) {
      out[(m0 + g) * 4 + col_off + c] = acc[0][0][h];
      out[(m0 + g + 8) * 4 + col_off + c] = acc[0][0][2 + h];
    }
  }
}

// Dense-lane frequency encoding of a 3-vector: [x | sin(2^i x_c) | cos(2^i x_c) | 0],
// lane 3 + 3i + c in the sin block, 3 + 3L + 3i + c in the cos block.
__device__ __forceinline__ float dense_lane(const float* x, int lane, int levels) {
  if (lane < 3) return x[lane];
  int q = lane - 3;
  const bool is_sin = q < 3 * levels;
  if (!is_sin) q -= 3 * levels;
  if (q >= 3 * levels) return 0.f;
  const float a = x[q % 3] * static_cast<float>(1 << (q / 3));  // exact scaling
  return is_sin ? sinf(a) : cosf(a);
}

template <int D>
__host__ __device__ constexpr size_t act_elems() { return static_cast<size_t>(kPts) * (D + kPad); }

// Position encodings of one pass: pe[p][k] for the 128 samples z[0..127] of the
// ray [o | v | dir]. o + v*z is formed with explicitly rounded mul and add.
__device__ __forceinline__ void encode_pass(bf16* pe, const float* ray, const float* z) {
  for (int e = threadIdx.x; e < kPts * kPe; e += kThreads) {
    const int p = e / kPe, k = e % kPe;
    const float zz = z[p];
    float pts[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) pts[c] = __fadd_rn(ray[c], __fmul_rn(ray[3 + c], zz));
    pe[p * kLdPe + k] = __float2bfloat16_rn(dense_lane(pts, k, 10));
  }
}

// Per-ray direction part of the rgb-hidden layer, folded into its bias:
// de[k] is the bf16-rounded direction encoding, debias = de @ wrde + b.
template <int D>
__device__ __forceinline__ void direction_bias(const Net& net, const float* ray, float* de,
                                               float* debias) {
  const int tid = threadIdx.x;
  if (tid < kDe) de[tid] = __bfloat162float(__float2bfloat16_rn(dense_lane(ray + 6, tid, 4)));
  __syncthreads();
  for (int j = tid; j < D / 2; j += kThreads) {
    const bf16* wr = net.w[12] + static_cast<size_t>(j) * kDe;
    float acc = 0.f;
    for (int k = 0; k < kDe; ++k) acc = fmaf(de[k], __bfloat162float(wr[k]), acc);
    debias[j] = acc + net.b[10][j];
  }
}

// Copy a pass's 128 x COLS activations from shared memory (row stride ld) to a
// dense (128, COLS) block of device memory, or back.
template <int COLS>
__device__ __forceinline__ void stash_store(const bf16* src, int ld, bf16* dst) {
  constexpr int kVec = COLS / 8;
  for (int e = threadIdx.x; e < kPts * kVec; e += kThreads) {
    const int row = e / kVec, v = e % kVec;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * COLS + 8 * v) =
        *reinterpret_cast<const uint4*>(src + row * ld + 8 * v);
  }
}

template <int COLS>
__device__ __forceinline__ void stash_load(bf16* dst, int ld, const bf16* src) {
  constexpr int kVec = COLS / 8;
  for (int e = threadIdx.x; e < kPts * kVec; e += kThreads) {
    const int row = e / kVec, v = e % kVec;
    *reinterpret_cast<uint4*>(dst + row * ld + 8 * v) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * COLS + 8 * v);
  }
}

// Elements of the activation stash of one pass: x0..x7 and feat (D each), h (D/2).
template <int D>
__host__ __device__ constexpr size_t stash_elems() {
  return static_cast<size_t>(kPts) * (9 * D + D / 2);
}

// The MLP over one pass of 128 points whose encoding is in `pe`: raw rgb and
// density into hout[4*p + 0..3]. With STASH every activation the backward
// needs is also written to `stash` (slots x0..x7, feat, h). Ends synchronised.
template <int D, bool STASH>
__device__ __forceinline__ void mlp_pass(const Net& net, const bf16* pe, bf16* buf_a, bf16* buf_b,
                                         const float* debias, float* hout, bf16* stash) {
  constexpr int ldx = D + kPad;
  constexpr size_t slot = static_cast<size_t>(kPts) * D;
  dense<kPe, 0, D, true>(pe, kLdPe, net.w[0], nullptr, 0, nullptr, net.b[0], buf_a, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_a, ldx, stash);
  dense<D, 0, D, true>(buf_a, ldx, net.w[1], nullptr, 0, nullptr, net.b[1], buf_b, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_b, ldx, stash + slot);
  dense<D, 0, D, true>(buf_b, ldx, net.w[2], nullptr, 0, nullptr, net.b[2], buf_a, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_a, ldx, stash + 2 * slot);
  dense<D, 0, D, true>(buf_a, ldx, net.w[3], nullptr, 0, nullptr, net.b[3], buf_b, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_b, ldx, stash + 3 * slot);
  dense<D, kPe, D, true>(buf_b, ldx, net.w[4], pe, kLdPe, net.w[5], net.b[4], buf_a, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_a, ldx, stash + 4 * slot);
  dense<D, 0, D, true>(buf_a, ldx, net.w[6], nullptr, 0, nullptr, net.b[5], buf_b, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_b, ldx, stash + 5 * slot);
  dense<D, 0, D, true>(buf_b, ldx, net.w[7], nullptr, 0, nullptr, net.b[6], buf_a, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_a, ldx, stash + 6 * slot);
  dense<D, 0, D, true>(buf_a, ldx, net.w[8], nullptr, 0, nullptr, net.b[7], buf_b, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_b, ldx, stash + 7 * slot);
  // x7 is in buf_b: density head (raw, f32) and feat (bf16, no ReLU)
  head<D>(buf_b, ldx, net.w[9], net.b[8], hout, 3, 1);
  dense<D, 0, D, false>(buf_b, ldx, net.w[10], nullptr, 0, nullptr, net.b[9], buf_a, ldx);
  __syncthreads();
  if (STASH) stash_store<D>(buf_a, ldx, stash + 8 * slot);
  dense<D, 0, D / 2, true>(buf_a, ldx, net.w[11], nullptr, 0, nullptr, debias, buf_b, ldx);
  __syncthreads();
  if (STASH) stash_store<D / 2>(buf_b, ldx, stash + 9 * slot);
  head<D / 2>(buf_b, ldx, net.w[13], net.b[11], hout, 0, 3);
  __syncthreads();
}

__device__ __forceinline__ float density_act(float raw, int occ_softplus) {
  return occ_softplus ? fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw))) : fmaxf(raw, 0.f);
}

// alpha[s] from the raw densities hout[4s+3] and z, then the f32 exclusive
// prefix sum of log(1 - alpha + eps) over the ray's S samples: a block-wide
// Hillis-Steele scan, ping-ponging scan0/scan1. Returns the buffer that holds
// the prefix sums; ends synchronised.
__device__ __forceinline__ float* alpha_and_prefix(const float* hout, const float* fz, float* alpha,
                                                   float* scan0, float* scan1, int S,
                                                   int occ_softplus, int head_dist_alpha,
                                                   int dist_alpha) {
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += kThreads) {
    const float sigma = density_act(hout[4 * s + 3], occ_softplus);
    const float occ = head_dist_alpha ? sigma : 1.f - expf(-sigma);
    float a = occ;
    if (dist_alpha) a = (s == S - 1) ? 1.f : 1.f - expf(-occ * (fz[s + 1] - fz[s]));
    alpha[s] = a;
  }
  __syncthreads();
  for (int s = tid; s < S; s += kThreads)
    scan0[s] = s >= 1 ? logf(1.f - alpha[s - 1] + kEps) : 0.f;
  __syncthreads();
  float* src = scan0;
  float* dst = scan1;
  for (int d = 1; d < S; d <<= 1) {
    for (int s = tid; s < S; s += kThreads) dst[s] = s >= d ? src[s] + src[s - d] : src[s];
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

// Sum each of part[0..N) over the block: shuffles inside a warp, then the warps
// in order, so the result does not depend on scheduling. red holds N*kWarps
// floats; the sums are left in red[0..N) for every thread. Ends synchronised.
template <int N>
__device__ __forceinline__ void block_sum(float (&part)[N], float* red) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < N; ++c) red[N * warp + c] = part[c];
  }
  __syncthreads();
  float acc = 0.f;
  if (threadIdx.x < N) {
    for (int w = 0; w < kWarps; ++w) acc += red[N * w + threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x < N) red[threadIdx.x] = acc;
  __syncthreads();
}

}  // namespace
