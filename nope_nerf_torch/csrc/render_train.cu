// Fused train step of the NeRF render on Hopper (sm_90a): K1, per ray the
// forward render, the rgb and depth loss sums, the analytic cotangents and
// the whole backward with every weight gradient.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_render.py::_render_train_kernel
// (reached through _raw_render_train / render_ray_loss_fused). It is the
// LOSS instance of render_full_sm90.cuh's kernel template, which describes
// what it computes, its bound and its design: the wgmma dX chain of
// mlp_dx_sm90.cuh saving the operands of its dW products, the in-order sum
// of its per-CTA partials, and the weight-gradient kernel of dw_sm90.cuh.
// render_bwd.cu (K4 full) is the same template reading its cotangents.

#include "render_full_sm90.cuh"

namespace {
constexpr bool kXwide = false;   // hidden_dim 128 to 512
}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py; at
// hidden_dim 640 to 1024 render_train_xwide.cu has the same entries.

// Offsets (floats) of the 14 dW blocks, the 12 dB blocks and the loss sums in
// the gradient buffer, into offsets[27]; returns the buffer's length, or 0
// for a width the kernel is not built for.
extern "C" int nerf_train_grad_layout(int D, int* offsets) {
  return render_grad_layout<kXwide>(D, offsets, true);
}

// Bytes of nerf_render_train's scratch buffers for chunks of chunk_rays rays
// into sizes[0..3]: the X and G operands of one chunk, the chain's partial
// sums, the dW kernel's partials per chunk of samples; the dW kernel's CTA
// tiles into sizes[4], from which the caller picks the chunks; the per-sample
// arrays' spill into sizes[5] (0 where they fit in shared memory); from
// hidden_dim 384 on the 64-point chain's per-CTA scratch into sizes[6] (the
// parked g4, the column sums, a ray's masks and h, past 512 the staging; 0 at
// 128 and 256). Returns 0, or cudaErrorInvalidValue for a width the kernel is
// not built for.
extern "C" int nerf_render_train_scratch(int D, long long chunk_rays, int S, int n_ctas,
                                         long long* sizes) {
  return static_cast<int>(render_full_scratch<kXwide>(D, chunk_rays, S, n_ctas, sizes));
}

// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, tgt
// (n_rays, 7) f32, contiguous on the device; tiles: pack_tiles' forward
// weight buffer, tiles_dx: pack_tiles_dx's backward buffer (both 16-byte
// aligned); biases: 12 f32 device pointers in pack_weights' order. xops, gops,
// chain_part, dw_part, spill: scratch of the sizes nerf_render_train_scratch
// gives for chunk_rays (dw_part: chunks times its size; scratch: sizes[6];
// all 16-byte aligned; spill and scratch null where their sizes are 0).
// grads: total f32 (out); drays (n_rays, 9),
// dz (n_rays, S), dtgt (n_rays, 7) f32 (out). The rays go in chunks of
// chunk_rays (the last one takes the rest); 0 < n_ctas <= chunk_rays <=
// n_rays, 0 < chunks <= chunk_rays S / 128. launches: 2 ints (out), the
// launches made of the chain kernel (one a chunk of rays) and of the dW
// kernel. Returns a cudaError_t (0 on success); the launches are asynchronous
// on `stream`.
extern "C" int nerf_render_train(const float* rays, const float* z, const float* tgt,
                                 const void* tiles, const void* tiles_dx,
                                 const void* const* biases, void* xops, void* gops,
                                 float* chain_part, float* dw_part, float* spill, void* scratch,
                                 float* grads, float* drays, float* dz, float* dtgt, int n_rays,
                                 int chunk_rays, int S, int D, int n_ctas, int chunks,
                                 int occ_softplus, int head_dist_alpha, int dist_alpha, int rgb_p,
                                 int white_bg, int total, int* launches, void* stream) {
  return render_train_entry<kXwide>(rays, z, tgt, tiles, tiles_dx, biases, xops, gops, chain_part,
                                    dw_part, spill, scratch, grads, drays, dz, dtgt, n_rays,
                                    chunk_rays, S, D, n_ctas, chunks, occ_softplus,
                                    head_dist_alpha, dist_alpha, rgb_p, white_bg, total, launches,
                                    stream);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
