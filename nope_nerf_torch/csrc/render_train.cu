// Fused train step of the NeRF render on Hopper (sm_90a): per ray, the forward
// render, the rgb and depth loss sums, the analytic cotangents and the whole
// backward, in one launch.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_render.py::_render_train_kernel
// (reached through _raw_render_train / render_ray_loss_fused). What it
// computes follows that kernel and its helpers (_fwd_tail, _alpha_forward,
// _composite_forward, _backward_tail, pallas_mlp.py::_bwd_chain_core):
//   forward as render_fwd.cu (the same device code, nerf_mlp.cuh);
//   loss sums [sum|rgb-gt|^p, sum m|dist-dgt|, sum (rgb-gt)^2] and the
//   cotangents g_rgb = w_rgb d|.|^p, g_dist = w_depth m sign(dist-dgt);
//   composite backward in f32 with a Hillis-Steele suffix scan;
//   MLP backward with every cotangent rounded to bf16 before it enters a
//   product (dX = g W^T, dW = x^T g), ReLU masks from the bf16 activations,
//   bias gradients from the f32 cotangent;
//   encoding backward with the forward's f32 sin/cos -> d(ray table), dz.
// Outputs: dW (14 blocks, stored (in, out)), dB (12), the 3 loss sums,
// d(rays) (N,9), dz (N,S), d(target table) (N,7).
//
// Bound: compute. Forward + dX + dW are three products per layer, about
// 3.5 MFLOP per point, against a few MB of ray, weight and gradient I/O; the
// activation stash below adds 4.9 KB written and read per point.
//
// Design (simple first, speed later):
// - A persistent grid of one CTA of 8 warps per SM; CTA c takes rays c, c+G, ...
//   A ray is processed in passes of 128 samples, as in render_fwd.cu.
// - Activations do not fit on chip for the backward: the forward writes
//   x0..x7, feat and h of every pass (bf16) to a per-CTA stash in device memory
//   (622 KB per 128-sample ray at D = 256; it is re-read within the same ray,
//   so it lives in L2). The backward keeps three 128 x (D+8) bf16 buffers in
//   shared memory: the cotangent g_l, the activation x_{l-1} read back from
//   the stash, and the cotangent g_{l-1} being produced.
// - dX products are the forward's mma.sync tiles on the (in, out) copy of the
//   weights. dW = x^T g takes both operands from shared memory through
//   ldmatrix.trans (points are the k dimension) and adds its f32 tile into a
//   per-CTA partial copy of the gradient buffer in device memory. No float
//   atomics anywhere: a second kernel sums the G partial buffers in CTA order,
//   so two launches give the same bits.
// - The direction encoding is per ray: the bf16-rounded g_h is summed over the
//   ray's samples first, and dW[wrde] = de^T (sum g_h), dde = (sum g_h) wrde^T
//   are formed once per ray (the TPU kernel forms them per point and sums;
//   the difference is f32 summation order).
// - The first-layer and skip-layer encoding gradients are formed together at
//   the end of the chain (g4 waits in the stash slot x4 vacated), so the
//   encoding derivative, with its sinf/cosf, is evaluated once per point.
// - backward_tail (nerf_bwd.cuh) takes g_rgb_ray, g_dist and optional per-sample
//   g_w, g_a cotangents: the train kernel forms the first two itself and passes
//   no g_w, g_a; render_bwd.cu, which receives all four as inputs, shares the
//   forward-with-stash and the whole backward chain with this kernel.

#include "nerf_bwd.cuh"

namespace {

constexpr int kTgt = 7;                 // target table columns
constexpr int kTgtDepth = 3, kTgtMask = 4, kTgtWrgb = 5, kTgtWdepth = 6;

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
render_train_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                    const float* __restrict__ tgt, Net net, NetT nett, bf16* stash,
                    float* partials, float* __restrict__ drays, float* __restrict__ dz,
                    float* __restrict__ dtgt, int n_rays, int S, int occ_softplus,
                    int head_dist_alpha, int dist_alpha, int rgb_p, int white_bg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GradLayout lay = grad_layout(D);
  RayCtx ctx;
  float* debias;
  // cot: g_rgb_ray (0-2), g_dist (3), CTA loss sums (8-10)
  float* cot = ray_ctx_init<D>(ctx, smem_raw, S, stash, partials, lay.total, &debias);
  const int tid = threadIdx.x;

  for (int r = blockIdx.x; r < n_rays; r += gridDim.x) {
    forward_stash<D>(ctx, net, debias, rays, z, r, S, occ_softplus, head_dist_alpha, dist_alpha);

    // ---- loss values and analytic cotangents -----------------------------
    if (tid == 0) {
      const float* tg = tgt + static_cast<size_t>(r) * kTgt;
      const float m = tg[kTgtMask], w_rgb = tg[kTgtWrgb], w_depth = tg[kTgtWdepth];
      float row_rgb = 0.f, row_l2 = 0.f;
      float* dt = dtgt + static_cast<size_t>(r) * kTgt;
      for (int c = 0; c < 3; ++c) {
        float v = ctx.red[c];
        if (white_bg) v += 1.f - ctx.red[4];
        const float diff = v - tg[c];
        row_rgb += rgb_p == 1 ? fabsf(diff) : diff * diff;
        row_l2 += diff * diff;
        const float sgn = static_cast<float>((diff > 0.f) - (diff < 0.f));
        cot[c] = w_rgb * (rgb_p == 1 ? sgn : 2.f * diff);
        dt[c] = -cot[c];
      }
      const float ddiff = ctx.red[3] - tg[kTgtDepth];
      const float row_depth = m * fabsf(ddiff);
      cot[3] = w_depth * m * static_cast<float>((ddiff > 0.f) - (ddiff < 0.f));
      dt[kTgtDepth] = -cot[3];
      dt[kTgtMask] = 0.f;
      dt[kTgtWrgb] = row_rgb;
      dt[kTgtWdepth] = row_depth;
      cot[8] += row_rgb;
      cot[9] += row_depth;
      cot[10] += row_l2;
    }
    __syncthreads();

    backward_tail<D, false, true>(ctx, net, nett, lay, cot, cot[3], nullptr, nullptr, S,
                                  occ_softplus, head_dist_alpha, dist_alpha, white_bg);

    if (tid < 9) drays[static_cast<size_t>(r) * 9 + tid] = ctx.rsum[tid];
    for (int s = tid; s < S; s += kThreads) dz[static_cast<size_t>(r) * S + s] = ctx.gz[s];
    __syncthreads();
  }
  if (tid < 3) ctx.part[lay.sums + tid] = cot[8 + tid];
}

template <int D>
cudaError_t launch_train(const float* rays, const float* z, const float* tgt, const Net& net,
                         const NetT& nett, bf16* stash, float* partials, float* grads,
                         float* drays, float* dz, float* dtgt, int n_rays, int S, int n_ctas,
                         int occ_softplus, int head_dist_alpha, int dist_alpha, int rgb_p,
                         int white_bg, cudaStream_t stream) {
  const size_t smem = train_smem_bytes<D>(S);
  cudaError_t err = cudaFuncSetAttribute(render_train_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_train_kernel<D><<<n_ctas, kThreads, smem, stream>>>(
      rays, z, tgt, net, nett, stash, partials, drays, dz, dtgt, n_rays, S, occ_softplus,
      head_dist_alpha, dist_alpha, rgb_p, white_bg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = grad_layout(D).total;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partials, grads, total,
                                                                  n_ctas);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py.

// Offsets (floats) of the 14 dW blocks, the 12 dB blocks and the loss sums in
// the gradient buffer, into offsets[27]; returns the buffer's length, or 0
// for a width the kernel is not built for.
extern "C" int nerf_train_grad_layout(int D, int* offsets) {
  if (D != 128 && D != 256) return 0;
  const GradLayout lay = grad_layout(D);
  for (int i = 0; i < 14; ++i) offsets[i] = lay.w[i];
  for (int i = 0; i < 12; ++i) offsets[14 + i] = lay.b[i];
  offsets[26] = lay.sums;
  return lay.total;
}

// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, tgt
// (n_rays, 7) f32, contiguous on the device; weights (out, in), weights_t
// (in, out): 14 bf16 device pointers each in the Net layout; biases: 12 f32
// pointers. stash: n_ctas * S * 9.5 D bf16; partials: n_ctas * total f32;
// grads: total f32 (out); drays (n_rays, 9), dz (n_rays, S), dtgt (n_rays, 7)
// f32 (out). n_ctas <= n_rays. Returns a cudaError_t (0 on success); the two
// launches are asynchronous on `stream`.
extern "C" int nerf_render_train(const float* rays, const float* z, const float* tgt,
                                 const void* const* weights, const void* const* weights_t,
                                 const void* const* biases, void* stash, float* partials,
                                 float* grads, float* drays, float* dz, float* dtgt, int n_rays,
                                 int S, int D, int n_ctas, int occ_softplus,
                                 int head_dist_alpha, int dist_alpha, int rgb_p, int white_bg,
                                 int total, void* stream) {
  if (n_rays <= 0 || n_ctas <= 0 || n_ctas > n_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S % kPts != 0 || S > kMaxTrainS) return static_cast<int>(cudaErrorInvalidValue);
  if ((D != 128 && D != 256) || total != grad_layout(D).total)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rgb_p != 1 && rgb_p != 2) return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  NetT nett;
  for (int i = 0; i < 14; ++i) {
    net.w[i] = static_cast<const bf16*>(weights[i]);
    nett.w[i] = static_cast<const bf16*>(weights_t[i]);
  }
  for (int i = 0; i < 12; ++i) net.b[i] = static_cast<const float*>(biases[i]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* sp = static_cast<bf16*>(stash);
  cudaError_t err;
  if (D == 256)
    err = launch_train<256>(rays, z, tgt, net, nett, sp, partials, grads, drays, dz, dtgt, n_rays,
                            S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha, rgb_p, white_bg,
                            st);
  else
    err = launch_train<128>(rays, z, tgt, net, nett, sp, partials, grads, drays, dz, dtgt, n_rays,
                            S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha, rgb_p, white_bg,
                            st);
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
