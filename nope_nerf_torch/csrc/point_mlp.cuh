// Device code shared by the point-query MLP kernels (point_mlp_fwd.cu,
// point_mlp_bwd.cu): a pass of 128 consecutive points, each with its own
// direction, instead of a ray's samples. It reuses the render kernels' dense
// layers, heads and backward products (nerf_mlp.cuh, nerf_bwd.cuh) as they are;
// only the per-point direction part of the rgb-hidden layer and the loading and
// encoding of a pass are new here.

#pragma once

#include "nerf_bwd.cuh"

namespace {

constexpr int kLdDe = kDe + kPad;   // bf16 row stride of a pass's direction encodings

// Points [p0, p0 + n) and their directions (n <= 128) into xs and ds (128 x 3
// f32 each); rows n..127 of a ragged last pass are zero.
__device__ __forceinline__ void load_points(float* xs, float* ds, const float* __restrict__ pts,
                                            const float* __restrict__ dirs, long long p0, int n) {
  for (int e = threadIdx.x; e < kPts * 3; e += kThreads) {
    const bool live = e < 3 * n;
    xs[e] = live ? pts[3 * p0 + e] : 0.f;
    ds[e] = live ? dirs[3 * p0 + e] : 0.f;
  }
}

// bf16 dense-lane encodings of a pass: pe[p][0..64) of the positions (row stride
// ldpe) and, unless de is null, de[p][0..32) of the directions (row stride kLdDe).
__device__ __forceinline__ void encode_points(bf16* pe, int ldpe, bf16* de, const float* xs,
                                              const float* ds) {
  for (int e = threadIdx.x; e < kPts * kPe; e += kThreads) {
    const int p = e / kPe, k = e % kPe;
    pe[p * ldpe + k] = __float2bfloat16_rn(dense_lane(xs + 3 * p, k, 10));
  }
  if (de == nullptr) return;
  for (int e = threadIdx.x; e < kPts * kDe; e += kThreads) {
    const int p = e / kDe, k = e % kDe;
    de[p * kLdDe + k] = __float2bfloat16_rn(dense_lane(ds + 3 * p, k, 4));
  }
}

// The MLP over one pass of 128 points, encodings in pe (row stride kLdPe) and de:
// raw rgb and density into hout[4*p + 0..3]. As nerf_mlp.cuh's mlp_pass, except
// that the rgb-hidden layer takes each point's own direction encoding as a
// second product (feat @ wrx^T + de @ wrde^T + b) instead of a per-ray bias.
// With STASH every activation the backward needs goes to `stash` (slots
// x0..x7, feat, h). Ends synchronised.
template <int D, bool STASH>
__device__ __forceinline__ void point_mlp_pass(const Net& net, const bf16* pe, const bf16* de,
                                               bf16* buf_a, bf16* buf_b, float* hout,
                                               bf16* stash) {
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
  dense<D, kDe, D / 2, true>(buf_a, ldx, net.w[11], de, kLdDe, net.w[12], net.b[10], buf_b, ldx);
  __syncthreads();
  if (STASH) stash_store<D / 2>(buf_b, ldx, stash + 9 * slot);
  head<D / 2>(buf_b, ldx, net.w[13], net.b[11], hout, 0, 3);
  __syncthreads();
}

}  // namespace
