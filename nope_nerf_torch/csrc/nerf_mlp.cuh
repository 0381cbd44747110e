// Device code shared by every kernel of the NeRF MLP: the bf16 type, the
// pass and encoding widths, the dense-lane frequency encoding and the
// density activation. The weights' layout is that of
// nope_nerf_torch.ops.fused_render.pack_weights (mlp_fwd_sm90.cuh's Tiles
// and mlp_dx_sm90.cuh's TilesDx are its slices).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPts = 128;               // points per pass (a tile of 128 rows)
constexpr int kPe = 64;                 // position encoding lanes (63 live)
constexpr int kDe = 32;                 // direction encoding lanes (27 live)
constexpr float kEps = 1e-6f;           // compositing epsilon (reference rendering.py:9)

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

__device__ __forceinline__ float density_act(float raw, int occ_softplus) {
  return occ_softplus ? fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw))) : fmaxf(raw, 0.f);
}

}  // namespace
