// Backward of the fused NeRF render on Hopper (sm_90a): K4's full variant,
// per ray the forward recomputed, then the whole backward with every weight
// gradient from cotangents that arrive as inputs.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_render.py::_render_bwd_kernel
// (reached through _raw_render_bwd, the VJP of render_rays_fused and
// render_rays_fused_noaux). It is the instance without LOSS of
// render_full_sm90.cuh's kernel template, which describes what it computes,
// its bound and its design: the cotangents of the rays' rgb (3) and dist,
// and optionally of the per-sample weights and alpha (S each), are read
// from device memory; a white background is applied outside the kernel, so
// its gradient arrives through the weights' cotangent. Fed the cotangents
// render_train.cu (K1) forms itself, it reproduces K1's gradients bit for
// bit. The variant for a frozen network, which forms only d(rays) and dz
// (all test-time pose optimisation needs), is render_bwd_frozen.cu; its
// results are this one's d(rays) and dz bit for bit.

#include "render_full_sm90.cuh"

namespace {
constexpr bool kXwide = false;   // hidden_dim 128 to 512
}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py; at
// hidden_dim 640 to 1024 render_bwd_xwide.cu has the same entries.

// Offsets (floats) of the 14 dW blocks and the 12 dB blocks in the gradient
// buffer, into offsets[26]; returns the buffer's length, or 0 for a width the
// kernel is not built for. (The layout is the train kernel's; its 3 loss sums
// stay 0 here.)
extern "C" int nerf_bwd_grad_layout(int D, int* offsets) {
  return render_grad_layout<kXwide>(D, offsets, false);
}

// Bytes of nerf_render_bwd's scratch buffers into sizes[0..6], as
// nerf_render_train_scratch gives them for the train kernel.
extern "C" int nerf_render_bwd_scratch(int D, long long chunk_rays, int S, int n_ctas,
                                       long long* sizes) {
  return static_cast<int>(render_full_scratch<kXwide>(D, chunk_rays, S, n_ctas, sizes));
}

// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, g_rgb
// (n_rays, 3), g_dist (n_rays) f32, contiguous on the device; g_w, g_a
// (n_rays, S) f32 or null (a zero cotangent); tiles, tiles_dx, biases, the
// scratch, grads, drays, dz, the chunks of rays and launches as
// nerf_render_train's. Returns a cudaError_t (0 on success); the launches
// are asynchronous on `stream`.
extern "C" int nerf_render_bwd(const float* rays, const float* z, const float* g_rgb,
                               const float* g_dist, const float* g_w, const float* g_a,
                               const void* tiles, const void* tiles_dx,
                               const void* const* biases, void* xops, void* gops,
                               float* chain_part, float* dw_part, float* spill, void* scratch,
                               float* grads, float* drays, float* dz, int n_rays, int chunk_rays,
                               int S, int D, int n_ctas, int chunks, int occ_softplus,
                               int head_dist_alpha, int dist_alpha, int total, int* launches,
                               void* stream) {
  return render_bwd_entry<kXwide>(rays, z, g_rgb, g_dist, g_w, g_a, tiles, tiles_dx, biases, xops,
                                  gops, chain_part, dw_part, spill, scratch, grads, drays, dz,
                                  n_rays, chunk_rays, S, D, n_ctas, chunks, occ_softplus,
                                  head_dist_alpha, dist_alpha, total, launches, stream);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
