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

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py.

// Offsets (floats) of the 14 dW blocks, the 12 dB blocks and the loss sums in
// the gradient buffer, into offsets[27]; returns the buffer's length, or 0
// for a width the kernel is not built for.
extern "C" int nerf_train_grad_layout(int D, int* offsets) {
  return render_grad_layout(D, offsets, true);
}

// Bytes of nerf_render_train's scratch buffers into sizes[0..3]: the X and
// G operands, the chain's partial sums, the dW kernel's partials per chunk of
// samples; and the dW kernel's CTA tiles into sizes[4], from which the caller
// picks the chunks. Returns 0, or cudaErrorInvalidValue for a width the
// kernel is not built for.
extern "C" int nerf_render_train_scratch(int D, long long n_rays, int S, int n_ctas,
                                         long long* sizes) {
  return static_cast<int>(render_full_scratch(D, n_rays, S, n_ctas, sizes));
}

// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, tgt
// (n_rays, 7) f32, contiguous on the device; tiles: pack_tiles' forward
// weight buffer, tiles_dx: pack_tiles_dx's backward buffer (both 16-byte
// aligned); biases: 12 f32 device pointers in pack_weights' order. xops, gops,
// chain_part, dw_part: scratch of the sizes nerf_render_train_scratch gives
// (dw_part: chunks times its size; all 16-byte aligned). grads: total f32
// (out); drays (n_rays, 9), dz (n_rays, S), dtgt (n_rays, 7) f32 (out).
// 0 < n_ctas <= n_rays, 0 < chunks <= n_rays S / 128. Returns a cudaError_t
// (0 on success); the launches are asynchronous on `stream`.
extern "C" int nerf_render_train(const float* rays, const float* z, const float* tgt,
                                 const void* tiles, const void* tiles_dx,
                                 const void* const* biases, void* xops, void* gops,
                                 float* chain_part, float* dw_part, float* grads, float* drays,
                                 float* dz, float* dtgt, int n_rays, int S, int D, int n_ctas,
                                 int chunks, int occ_softplus, int head_dist_alpha,
                                 int dist_alpha, int rgb_p, int white_bg, int total,
                                 void* stream) {
  cudaError_t err = render_full_check(n_rays, S, D, n_ctas, chunks, total, tiles, tiles_dx, xops,
                                      gops);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rgb_p != 1 && rgb_p != 2) return static_cast<int>(cudaErrorInvalidValue);
  Biases bias;
  for (int i = 0; i < 12; ++i) bias.b[i] = static_cast<const float*>(biases[i]);
  RayCotangents cin{tgt, dtgt, rgb_p, white_bg, nullptr, nullptr, nullptr, nullptr};
  const RenderFlags fl{occ_softplus, head_dist_alpha, dist_alpha};
  const auto* w = static_cast<const unsigned char*>(tiles);
  const auto* wdx = static_cast<const unsigned char*>(tiles_dx);
  auto* xo = static_cast<unsigned char*>(xops);
  auto* go = static_cast<unsigned char*>(gops);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = D == 256
      ? render_full_launch<256, true>(rays, z, cin, w, wdx, bias, xo, go, chain_part, dw_part,
                                      grads, drays, dz, n_rays, S, n_ctas, chunks, fl, st)
      : render_full_launch<128, true>(rays, z, cin, w, wdx, bias, xo, go, chain_part, dw_part,
                                      grads, drays, dz, n_rays, S, n_ctas, chunks, fl, st);
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
