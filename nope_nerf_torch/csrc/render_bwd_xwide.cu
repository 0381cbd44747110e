// Backward of the fused NeRF render on Hopper (sm_90a) at hidden_dim 640, 768,
// 896 and 1024: K4's full variant, render_bwd.cu's function past 512, the
// instance without LOSS of render_full_sm90.cuh's render_full_xwide_kernel.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_render.py::_render_bwd_kernel
// at these widths (reached through _raw_render_bwd, the VJP of
// render_rays_fused) when the network takes gradients. Its design, bound,
// invariants and expected trouble are render_train_xwide.cu's (K1 past 512,
// the LOSS instance): fed K1's cotangents it gives K1's gradients bit for
// bit, and its d(rays) and dz are render_bwd_frozen.cu's xwide kernel's bit
// for bit. A translation unit of its own, so render_bwd.cu's 128 to 512
// instances keep their SASS.

#include "render_full_sm90.cuh"

namespace {
constexpr bool kXwide = true;   // hidden_dim 640 to 1024
}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py:
// render_bwd.cu's entries, at hidden_dim 640, 768, 896 and 1024 (0 or
// cudaErrorInvalidValue at any other), with the same arguments.

extern "C" int nerf_bwd_grad_layout(int D, int* offsets) {
  return render_grad_layout<kXwide>(D, offsets, false);
}

extern "C" int nerf_render_bwd_scratch(int D, long long chunk_rays, int S, int n_ctas,
                                       long long* sizes) {
  return static_cast<int>(render_full_scratch<kXwide>(D, chunk_rays, S, n_ctas, sizes));
}

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
