// Backward of the fused NeRF render on Hopper (sm_90a): per ray, the forward
// recomputed with every activation stashed, then the whole backward from
// cotangents that arrive as inputs.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_render.py::_render_bwd_kernel
// (reached through _raw_render_bwd, the VJP of render_rays_fused and
// render_rays_fused_noaux). What it computes follows that kernel:
//   forward as render_fwd.cu (the same device code, nerf_mlp.cuh);
//   cotangents of the ray's rgb (3) and dist, and optionally of its per-sample
//   weights and alpha (S each), read from device memory;
//   composite, heads, MLP and encoding backward exactly as the train kernel's
//   (nerf_bwd.cuh::backward_tail, with its rounding: bf16 cotangents before
//   every product, ReLU masks from the bf16 activations, f32 bias sums, the
//   forward's f32 sin/cos). A white background is applied outside the kernel,
//   so its gradient arrives through the weights' cotangent.
// Outputs: dW (14 blocks, stored (in, out)), dB (12), d(rays) (N,9), dz (N,S).
//
// Two variants, chosen by the caller: the full one, and one for a frozen
// network (partials == null) that forms only the dX chain and so d(rays) and
// dz: test-time pose optimisation needs nothing else. The grid, the stash,
// the per-CTA partial gradient buffers summed in CTA order (no float atomics:
// two launches give the same bits) and the shared-memory plan are the train
// kernel's; render_train.cu describes them.
//
// Bound: compute, as the train kernel: forward + dX + dW are three products
// per layer (two without dW) against a 4.9 KB stash written and read per point.

#include "nerf_bwd.cuh"

namespace {

template <int D, bool DW>
__global__ void __launch_bounds__(kThreads, 1)
render_bwd_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                  const float* __restrict__ g_rgb, const float* __restrict__ g_dist,
                  const float* __restrict__ g_w, const float* __restrict__ g_a, Net net,
                  NetT nett, bf16* stash, float* partials, float* __restrict__ drays,
                  float* __restrict__ dz, int n_rays, int S, int occ_softplus,
                  int head_dist_alpha, int dist_alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GradLayout lay = grad_layout(D);
  RayCtx ctx;
  float* debias;
  // cot: g_rgb_ray (0-2), g_dist (3)
  float* cot = ray_ctx_init<D>(ctx, smem_raw, S, stash, DW ? partials : nullptr, lay.total,
                               &debias);
  const int tid = threadIdx.x;

  for (int r = blockIdx.x; r < n_rays; r += gridDim.x) {
    forward_stash<D>(ctx, net, debias, rays, z, r, S, occ_softplus, head_dist_alpha, dist_alpha);
    if (tid < 3) cot[tid] = g_rgb[static_cast<size_t>(r) * 3 + tid];
    if (tid == 3) cot[3] = g_dist[r];
    __syncthreads();

    const size_t row = static_cast<size_t>(r) * S;
    backward_tail<D, true, DW>(ctx, net, nett, lay, cot, cot[3],
                               g_w == nullptr ? nullptr : g_w + row,
                               g_a == nullptr ? nullptr : g_a + row, S, occ_softplus,
                               head_dist_alpha, dist_alpha, /*white_bg=*/0);

    if (tid < 9) drays[static_cast<size_t>(r) * 9 + tid] = ctx.rsum[tid];
    for (int s = tid; s < S; s += kThreads) dz[row + s] = ctx.gz[s];
    __syncthreads();
  }
}

template <int D, bool DW>
cudaError_t launch_bwd(const float* rays, const float* z, const float* g_rgb,
                       const float* g_dist, const float* g_w, const float* g_a, const Net& net,
                       const NetT& nett, bf16* stash, float* partials, float* grads,
                       float* drays, float* dz, int n_rays, int S, int n_ctas, int occ_softplus,
                       int head_dist_alpha, int dist_alpha, cudaStream_t stream) {
  const size_t smem = train_smem_bytes<D>(S);
  cudaError_t err = cudaFuncSetAttribute(render_bwd_kernel<D, DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_bwd_kernel<D, DW><<<n_ctas, kThreads, smem, stream>>>(
      rays, z, g_rgb, g_dist, g_w, g_a, net, nett, stash, partials, drays, dz, n_rays, S,
      occ_softplus, head_dist_alpha, dist_alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess || !DW) return err;
  const int total = grad_layout(D).total;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partials, grads, total,
                                                                  n_ctas);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py.

// Offsets (floats) of the 14 dW blocks and the 12 dB blocks in the gradient
// buffer, into offsets[26]; returns the buffer's length, or 0 for a width the
// kernel is not built for. (The layout is the train kernel's; its 3 loss sums
// stay 0 here.)
extern "C" int nerf_bwd_grad_layout(int D, int* offsets) {
  if (D != 128 && D != 256) return 0;
  const GradLayout lay = grad_layout(D);
  for (int i = 0; i < 14; ++i) offsets[i] = lay.w[i];
  for (int i = 0; i < 12; ++i) offsets[14 + i] = lay.b[i];
  return lay.total;
}

// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, g_rgb
// (n_rays, 3), g_dist (n_rays) f32, contiguous on the device; g_w, g_a
// (n_rays, S) f32 or null (a zero cotangent); weights (out, in), weights_t
// (in, out): 14 bf16 device pointers each in the Net layout; biases: 12 f32
// pointers. stash: n_ctas * S * 9.5 D bf16. partials: n_ctas * total f32 and
// grads: total f32 (out), or both null for the frozen-network variant, which
// writes no dW/dB. drays (n_rays, 9), dz (n_rays, S) f32 (out). n_ctas <=
// n_rays. Returns a cudaError_t (0 on success); the launches are asynchronous
// on `stream`.
extern "C" int nerf_render_bwd(const float* rays, const float* z, const float* g_rgb,
                               const float* g_dist, const float* g_w, const float* g_a,
                               const void* const* weights, const void* const* weights_t,
                               const void* const* biases, void* stash, float* partials,
                               float* grads, float* drays, float* dz, int n_rays, int S, int D,
                               int n_ctas, int occ_softplus, int head_dist_alpha,
                               int dist_alpha, int total, void* stream) {
  if (n_rays <= 0 || n_ctas <= 0 || n_ctas > n_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S % kPts != 0 || S > kMaxTrainS) return static_cast<int>(cudaErrorInvalidValue);
  if ((D != 128 && D != 256) || total != grad_layout(D).total)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((partials == nullptr) != (grads == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  NetT nett;
  for (int i = 0; i < 14; ++i) {
    net.w[i] = static_cast<const bf16*>(weights[i]);
    nett.w[i] = static_cast<const bf16*>(weights_t[i]);
  }
  for (int i = 0; i < 12; ++i) net.b[i] = static_cast<const float*>(biases[i]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* sp = static_cast<bf16*>(stash);
  const bool dw = partials != nullptr;
#define NERF_BWD_LAUNCH(DIM, FLAG)                                                              \
  launch_bwd<DIM, FLAG>(rays, z, g_rgb, g_dist, g_w, g_a, net, nett, sp, partials, grads,       \
                        drays, dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha,            \
                        dist_alpha, st)
  cudaError_t err;
  if (D == 256)
    err = dw ? NERF_BWD_LAUNCH(256, true) : NERF_BWD_LAUNCH(256, false);
  else
    err = dw ? NERF_BWD_LAUNCH(128, true) : NERF_BWD_LAUNCH(128, false);
#undef NERF_BWD_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
