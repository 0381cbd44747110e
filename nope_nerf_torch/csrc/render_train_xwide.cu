// Fused train step of the NeRF render on Hopper (sm_90a) at hidden_dim 640,
// 768, 896 and 1024: K1, render_train.cu's function, numerics and three
// launches per chunk of rays, on render_full_sm90.cuh's
// render_full_xwide_kernel (mlp_dx_xwide_sm90.cuh's chain with
// mlp_dw_chain_sm90.cuh's OperandSaveX<D, true> and rgb_head_bwd_x_full<D,
// true>) and the weight-gradient kernel of dw_sm90.cuh. render_bwd_xwide.cu
// (K4 full past 512) is the same template reading its cotangents.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_render.py::_render_train_kernel
// at these widths (reached through _raw_render_train / render_ray_loss_fused).
//
// A translation unit of its own, with render_train.cu's C entries
// (ops/fused_render.py binds this library past 512): K6 full's instances past
// 512, built beside its 384 and 512 kernels, moved those kernels' SASS, so
// render_train.cu and render_bwd.cu instantiate 128 to 512 only.
//
// Bound: compute, forward + dX + dW, three products a layer (chip_smoke.py's
// mlp_flops x 3): at 1024 rays x 128 samples 2.803 TFLOP at 640, 4.021 at
// 768, 5.457 at 896, 7.113 at 1024: 2.834, 4.065, 5.518 and 7.192 ms at 989
// TFLOP/s. The X and G operands handed to the dW kernel stay out of it.
//
// Design, per ray (render_full_wide_kernel's work in the order, producer,
// forward and per-ray code of render_bwd_frozen.cu's xwide kernel):
// - the ray and its cotangents; the rgb-hidden bias from the direction by
//   stage_w12_x and w12_x, render_fwd.cu's order;
// - each 64-point tile's forward once (mlp_tile_x_masks with the hook at pass
//   r S/64 + p: its X operands to their half row tiles, its masks to the
//   CTA's scratch), then its h (the buffer's first D/2 columns) parked in
//   the scratch, fenced;
// - the hook drained (the composite borrows the buffer), the composite
//   forward, with LOSS the loss rows and cotangents, the composite backward;
// - per tile: the bf16 raw-density cotangents, rgb_head_bwd_x_full (h from
//   the park; dB[10], dB[11], dB[8], dW[13] and the per-ray sum of bf16 g_h),
//   density_head_dw_w (dW[9] from x7's operand tile), dx_chain_x with the
//   hook (the G operands and the bias sums), the encoding VJP;
// - once per ray dW[12] += bf16(de)^T ghsum and the frozen kernel's
//   direction VJP (dir_vjp over w12_x).
// Per chunk of rays (ops/fused_render.py::render_chunks: 2 chunks of 512 rays
// at 1024 x 128 at every width here), the chain, the in-order sum of its
// partials, and the dW kernel on its 32 (640, 768), 43 (896) or 42 (1024)
// column pieces in two launches (chain_dw_launch), the rows in chunks of at
// most 64 row tiles (ops/fused_mlp.py::point_dw_chunks: 8 a chunk of rays at
// 1024 x 128), summed in f32 in chunk order. The dW kernel's code is
// unchanged.
//
// Invariants, fixed before the kernel's first run on a card (chip_smoke.py
// phases 16 and 15's F1, F2 hold them):
// (I1) K4 full's d(rays) and dz are torch.equal to K4 frozen's
//      (render_bwd_frozen_xwide_kernel) at every width from 640 to 1024, on
//      every case and both flag sets: the same producer, forward with its
//      masks, composite, g_h bits, chain (dx_chain_x) and direction VJP
//      (dir_vjp over w12_x); the hook only adds stores and sums.
// (I2) K4 full fed K1's own cotangents gives K1's dW, dB, d(rays) and dz bit
//      for bit.
// (I3) Two launches are bit-equal in every output, calls of more than one
//      chunk of rays included: no float atomics.
// (I4) The X operands K1 and K4 full hand the dW kernel are torch.equal to
//      those K3's check build writes from the same inputs, one chunk of rays
//      at a time.
// (I5) Every other instance keeps its SASS and its outputs: K1 and K4 full at
//      128 to 512, K4 frozen, K6 frozen and K6 full at 128 to 1024, K3, K5, the
//      dW and reduce kernels (tools/forward_timing.py --kernels full and
//      --kernels frozen --sass, parent, change, change, parent).
// (N1) tools/backward_noise.py --render-full --widths 640 1024: the mean L2
//      distance of the 26 dW and dB blocks from the f64 sum, per width and
//      flag set on 1024 rays x 128, at most 2.0 x the f32 plain version's
//      (K1 at each side's own cotangents), or the kernel is at fault.
//
// Where trouble was expected, and what the build found (PERF.md section 6; on
// an NVIDIA H100 80GB HBM3 at 700 W):
// - Spills: K6 full past 512 spilled 152 to 256 B of stores and 424 to 828 of
//   loads, K4 frozen past 512 108 / 216; this kernel adds the hook's state,
//   the park and the LOSS rows. Found (ptxas, stores / loads, the four
//   widths): K1 804 to 856 B / 2,588 to 2,760 B, K4 full 588 to 712 / 1,592
//   to 1,840; 168 registers.
// - The segment offsets: the render segments start at dW[12]
//   (OperandSaveX<D, true>::grad, rgb_head_bwd_x_full<D, true>, and
//   chain_reduce_launch's `from`); a wrong base shifts the dB blocks by
//   32 x D/2 floats. Each warpgroup's red_pass region (2 D floats of
//   red_at's 8 D) and the rgb head's 5 sums (5 D floats a warpgroup, of
//   red_bytes_w<D, true>'s 10 D) stay within its own half. Found: every dB
//   block within the rule on the first run.
// - h and the composite: the composite borrows the one activation buffer
//   between the forward and the backward, so h comes from the park; reading
//   it from the buffer would compile and give a wrong dW[13].
// - Scratch a CTA: g4 (64 x D bf16), the staging (64 x (D - 128)), the column
//   sums (10 D floats), and per 64-point tile its masks (9 x D/128 KB) and h
//   (64 x D/2 bf16): 347,136 B at 640 and 565,248 B at 1024 at S = 128
//   (45.8 and 74.6 MB over 132 CTAs, above L2's 50 MB at 1024; whether L2
//   thrashes there is not measured).
// - Shared memory: the frozen xwide kernel's, 216,296 B at 1024 and S = 128
//   (two ring stages); the per-sample arrays spill to device memory above
//   S = 1,920 at 640, 1,408 at 768, 896 at 896 and 384 at 1024, the
//   composite's above 4,096, 4,864, 5,632 and 6,528.
// - Numerics: (N1) read 0.84 to 0.99, and 0.88 to 1.80 at 384 and 512. On
//   the relu / dist_alpha flag set a ray's forced last sample carries over
//   half its weight, so one h mask there that flips between two f32
//   evaluations moves the rgb-hidden blocks past 5e-3 of their largest
//   entry in either (chip_smoke.past_512_hold).

#include "render_full_sm90.cuh"

namespace {
constexpr bool kXwide = true;   // hidden_dim 640 to 1024
}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py:
// render_train.cu's entries, at hidden_dim 640, 768, 896 and 1024 (0 or
// cudaErrorInvalidValue at any other), with the same arguments.

extern "C" int nerf_train_grad_layout(int D, int* offsets) {
  return render_grad_layout<kXwide>(D, offsets, true);
}

extern "C" int nerf_render_train_scratch(int D, long long chunk_rays, int S, int n_ctas,
                                         long long* sizes) {
  return static_cast<int>(render_full_scratch<kXwide>(D, chunk_rays, S, n_ctas, sizes));
}

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
