// Device code shared by the backward kernels (mlp_dx_sm90.cuh and the
// kernels on it): the gradient buffer's layout, the bf16 rounding of a
// cotangent and the dense-lane encoding's derivative.

#pragma once

#include "nerf_mlp.cuh"

namespace {

constexpr int kMaxTrainS = 256;         // shared-memory limit on S of the render backward kernels

// Offsets (in floats) of every block of the gradient buffer: 14 dW stored
// (in, out) with the heads' live columns only, 12 dB, then the 3 loss sums
// (the train kernel's; the other kernels leave them unused).
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
  g.total = (off + 3) / 4 * 4;   // a multiple of 4 floats
  return g;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

}  // namespace
