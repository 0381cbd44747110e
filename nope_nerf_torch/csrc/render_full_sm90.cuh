// The render backward with every weight gradient on Hopper (sm_90a): one
// kernel template for K1 (render_train.cu: LOSS, the cotangents formed in
// the kernel from the loss) and K4 full (render_bwd.cu: the cotangents read
// from device memory), on the wgmma dX chain of mlp_dx_sm90.cuh, handing
// its dW products to the weight-gradient kernel of dw_sm90.cuh
// (mlp_dw_chain_sm90.cuh).
//
// Replaces the TPU kernels nope_nerf_tpu/ops/pallas_render.py::
// _render_train_kernel (K1, reached through render_ray_loss_fused) and
// _render_bwd_kernel (K4, the VJP of render_rays_fused). What they compute
// (pallas_render.py:535-750, pallas_mlp.py::_bwd_chain_core): per ray the
// forward (raw heads, alpha, the f32 composite); with LOSS the loss rows
// [|rgb-gt|^p, m|dist-dgt|, (rgb-gt)^2], their CTA sums, the cotangents
// g_rgb = w_rgb d|.|^p, g_dist = w_depth m sign(dist-dgt) and d(target);
// the composite backward in f32; the head VJPs; the MLP backward with every
// cotangent rounded to bf16 before it enters a product (dX = g W^T,
// dW = x^T g), ReLU masks from the bf16 activations, each dB summed from the
// masked f32 cotangents; the encoding VJP with the forward's f32 sin/cos to
// d(rays) and dz. The direction part of the rgb-hidden layer is a per-ray
// bias, so dW[12] = bf16(de)^T (sum over the ray's samples of bf16 g_h), an
// f32 sum as right factor: it stays in the chain, per ray.
// Outputs: dW (14 blocks, stored (in, out)) and dB (12) in nerf_bwd.cuh's
// grad_layout, with LOSS the 3 loss sums after them; d(rays) (N, 9), dz
// (N, S); with LOSS d(target) (N, 7).
//
// Bound: compute. Forward + dX + dW are three products per layer, 3.5 MFLOP
// a sample at D = 256, against a few MB of rays, targets, weights and
// gradients. The operands handed to the dW kernel (4,736 B of X and 4,864 B
// of G a sample at D = 256, written once and read once) are the kernels'
// own choice and stay out of the bound.
//
// Design, three launches on one stream (render_full_launch):
// 1. The chain: render_bwd_frozen.cu's kernel (persistent CTAs over rays;
//    per ray the S/128 tiles through the wgmma forward, the composite
//    forward and backward over the ray in shared memory, each tile back
//    through the dX chain, after a second forward for its masks when
//    S = 256), which also
//    - saves the X operands pe, x0..x7, feat of each tile through the
//      forward's save hook, in the forward whose masks the dX chain uses, so
//      each tile's operands are written once (row tile r S/128 + p of every
//      operand: tile p of ray r);
//    - saves the G operands g_h, g_feat, g7..g0 from its dX layers, with
//      their bias column sums per warpgroup in warp order;
//    - keeps as per-CTA f32 partial sums what the dW kernel does not form:
//      dW[9] (x7 read back from its operand tile), dW[13] (h read before g_h
//      goes over it: the composite's arrays borrow the activation buffer's
//      blocks past h between the forward and the backward), dW[12] per ray
//      in ray order, dB[0..11] and the loss sums.
// 2. The chain's partials summed in CTA, then warpgroup, order.
// 3. dw_sm90.cuh on the 11-block table (mlp_dw_chain_sm90.cuh's
//    chain_dw_table without its direction block) over the N S samples.
// No float atomics: two launches give the same bits. K4 fed K1's own
// cotangents runs the same arithmetic and reproduces K1's gradients bit for
// bit, and K4's d(rays) and dz are the frozen variant's bit for bit (the
// same chain and the same per-ray pieces of mlp_dx_sm90.cuh).
//
// Shared memory at D=256: the frozen variant's (activations 64 KB, position
// encodings 16 KB, heads 6 KB, masks 34 KB) with f32 arrays of 15 KB (S=128)
// or 21 KB (S=256), 8 KB of them the per-warp bias sums, and two 32 KB ring
// stages.

#pragma once

#include "mlp_dw_chain_sm90.cuh"

namespace {

constexpr int kTgt = 7;                 // target table columns
constexpr int kTgtDepth = 3, kTgtMask = 4, kTgtWrgb = 5, kTgtWdepth = 6;

// Where a ray's cotangents come from. With LOSS: formed from its row of the
// target table `tgt` (rgb_gt, depth_gt, mask, w_rgb, w_depth), d(target)
// written to dtgt, rgb_p the rgb loss's power, white_bg its background. Else
// read: g_rgb (N, 3), g_dist (N), g_w and g_a (N, S) or null.
struct RayCotangents {
  const float* tgt;
  float* dtgt;
  int rgb_p, white_bg;
  const float* g_rgb;
  const float* g_dist;
  const float* g_w;
  const float* g_a;
};

struct RenderFlags {
  int occ_softplus, head_dist_alpha, dist_alpha;
};

// Reduction scratch: the dX layers' per-warp bias sums (2 x 4 x D), or the
// rgb head's 5 sums a consumer thread, whichever is larger.
template <int D>
__host__ __device__ constexpr int full_red_floats() {
  return 8 * D > 5 * kConsumers ? 8 * D : 5 * kConsumers;
}

// f32 arrays: z (S), heads (4S), graw (S), grgb (4S), gz (S), direction
// encoding (32), rgb-hidden bias (D/2), ghsum (D/2), reduction scratch, the
// ray (16), rsum (16), the tile's bf16 graw (128), the ray's cotangents and
// the CTA's loss sums (16).
template <int D>
size_t render_full_f32_bytes(int S) {
  return sizeof(float) * (11 * static_cast<size_t>(S) + kDe + D / 2 + D / 2 +
                          full_red_floats<D>() + 16 + 16 + kPts + 16);
}

// The render kernels' chain segment: dW[9], then dW[12] .. the loss sums.
__host__ __device__ inline int render_seg(int D) {
  const GradLayout lay = grad_layout(D);
  return chain_seg(D, lay.w[12], lay.sums + 3);
}

template <int D, bool LOSS>
__global__ void __launch_bounds__(kThreads90, 1)
render_full_kernel(const float* __restrict__ rays, const float* __restrict__ z, RayCotangents cin,
                   const unsigned char* __restrict__ tiles,
                   const unsigned char* __restrict__ tiles_dx, Biases bias, unsigned char* xops,
                   unsigned char* gops, float* chain_part, float* __restrict__ drays,
                   float* __restrict__ dz, int n_rays, int S, RenderFlags fl, Layout90<D> L) {
  using T = Tiles<D>;
  constexpr int H = D / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = setup90(smem_raw, L.bars, L.stages);
  Ring ring = make_ring(base, L.ring, L.bars, T::kFull, L.stages);
  const uint32_t head_bar = ring.full + 16 * kMaxStages;
  const uint32_t heads = smem_addr(base + L.heads);
  const Handoff hand = make_handoff(ring);
  const int passes = S / kPts;
  const bool again = passes > 1;   // a second forward per tile for its masks

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    render_producer90<D>(rays, z, tiles, tiles_dx, ring, heads, head_bar, hand, base + L.pe,
                         n_rays, S);
    return;
  }
  set_consumer_regs();

  const GradLayout lay = grad_layout(D);
  const int seg = render_seg(D);
  float* fz = reinterpret_cast<float*>(base + L.f32 + mask_bytes<D>());   // z     (S)
  float* hout = fz + S;                                 // rgb | raw density      (S,4)
  float* graw = hout + 4 * S;                           // raw-density cotangent  (S)
  float* grgb = graw + S;                               // raw-rgb cotangent      (S,4)
  float* gz = grgb + 4 * S;                             // dz                     (S)
  float* de = gz + S;                                   // direction encoding     (32)
  float* debias = de + kDe;                             // rgb-hidden bias        (D/2)
  float* ghsum = debias + H;                            // sum of bf16 g_h        (D/2)
  float* red = ghsum + H;                               // scratch
  float* ray = red + full_red_floats<D>();              // o | v | dir            (16)
  float* rsum = ray + 16;                               // d_o, d_v, d_dir        (16)
  float* gsbf = rsum + 16;                              // the tile's bf16 graw   (128)
  float* cot = gsbf + kPts;   // g_rgb (0-2), g_dist (3), the CTA's loss sums (8-10)
  // between the forward and the backward: alpha, weights, transmittance and
  // the scan buffers (S each) in the activation buffer's blocks past h, which
  // the rgb head's backward reads when S = 128
  float* alpha = reinterpret_cast<float*>(base + L.act + (H / 64) * kBlockBytes);
  float* wts = alpha + S;
  float* trans = wts + S;
  float* scan0 = trans + S;
  float* scan1 = scan0 + S;
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + L.f32);
  const uint32_t* mask_h = masks + 8 * mask_layer_words<D>();
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  // w12 staged for the per-ray bias and dde at the ray's start and end
  unsigned char* w12 = base + L.act;
  const uint32_t pe_s = smem_addr(base + L.pe);
  const int tid = threadIdx.x, wg = tid >> 7;
  // the segments: CTA-wide sums in the first, each warpgroup's dB in its own
  float* part0 = chain_part + static_cast<size_t>(blockIdx.x) * 2 * seg;
  float* part_wg = part0 + wg * seg;
  const int w12_at = D, w13_at = D + (lay.w[13] - lay.w[12]), b0_at = D + (lay.b[0] - lay.w[12]),
            sums_at = D + (lay.sums - lay.w[12]);
  for (int e = tid; e < 2 * seg; e += kConsumers) part0[e] = 0.f;
  __threadfence_block();
  if (tid < 16) cot[tid] = 0.f;
  OperandSave<D> save;
  save.act = base + L.act;
  save.pe = base + L.pe;
  save.de = nullptr;
  save.tiles = PassTiles<D>{xops, gops, static_cast<size_t>(n_rays) * passes * kBlockBytes, 0};
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
    consumer_sync();   // the previous ray is done with every buffer
    if (tid < 9) ray[tid] = rays[r * 9 + tid];
    if (!LOSS) {
      if (tid < 3) cot[tid] = cin.g_rgb[r * 3 + tid];
      if (tid == 3) cot[3] = cin.g_dist[r];
    }
    for (int s = tid; s < S; s += kConsumers) fz[s] = z[r * S + s];
    consumer_sync();
    if (tid < kDe) de[tid] = __bfloat162float(__float2bfloat16_rn(dense_lane(ray + 6, tid, 4)));
    stage_w12<D>(w12, tiles + T::kW12);
    consumer_sync();
    for (int j = tid; j < H; j += kConsumers) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kDe; ++k) {
        const bf16 wv = *reinterpret_cast<const bf16*>(w12 + swz(j, k, 0));
        acc = fmaf(de[k], __bfloat162float(wv), acc);
      }
      debias[j] = acc + bias.b[10][j];
    }
    consumer_sync();

    // ---- forward: every tile's raw heads; with one tile its masks and operands
    for (int p = 0; p < passes; ++p, ++tile) {
      if (again) {
        mlp_tile_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                          hout + 4 * p * kPts, hand, tile, ring, masks);
      } else {
        save.tiles.pass = r * passes + p;
        mlp_tile_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                          hout + 4 * p * kPts, hand, tile, ring, masks, save);
        __threadfence_block();   // x7's tile, before other threads read it back
      }
    }
    consumer_sync();
    float ray_sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};   // rgb (3), dist, sum of weights
    composite_fwd90(hout, fz, alpha, trans, wts, scan0, scan1, S, fl.occ_softplus,
                    fl.head_dist_alpha, fl.dist_alpha, LOSS ? ray_sums : nullptr);

    // ---- with LOSS: the loss rows and the analytic cotangents (render_train's)
    if (LOSS) {
      block_sum90<5>(ray_sums, red);
      if (tid == 0) {
        const float* tg = cin.tgt + r * kTgt;
        const float m = tg[kTgtMask], w_rgb = tg[kTgtWrgb], w_depth = tg[kTgtWdepth];
        float row_rgb = 0.f, row_l2 = 0.f;
        float* dt = cin.dtgt + r * kTgt;
        for (int c = 0; c < 3; ++c) {
          float v = red[c];
          if (cin.white_bg) v += 1.f - red[4];
          const float diff = v - tg[c];
          row_rgb += cin.rgb_p == 1 ? fabsf(diff) : diff * diff;
          row_l2 += diff * diff;
          const float sgn = static_cast<float>((diff > 0.f) - (diff < 0.f));
          cot[c] = w_rgb * (cin.rgb_p == 1 ? sgn : 2.f * diff);
          dt[c] = -cot[c];
        }
        const float ddiff = red[3] - tg[kTgtDepth];
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
      consumer_sync();
    }

    // ---- composite backward (f32) ---------------------------------------------
    composite_bwd90(cot, cot[3], LOSS ? cin.white_bg : 0,
                    LOSS || cin.g_w == nullptr ? nullptr : cin.g_w + r * S,
                    LOSS || cin.g_a == nullptr ? nullptr : cin.g_a + r * S, hout, fz, alpha,
                    trans, wts, scan0, scan1, graw, grgb, gz, S, fl.occ_softplus,
                    fl.head_dist_alpha, fl.dist_alpha);
    if (tid < H) ghsum[tid] = 0.f;
    if (tid < 16) rsum[tid] = 0.f;
    consumer_sync();

    // ---- heads -> MLP -> encoding, tile by tile -------------------------------
    for (int p = 0; p < passes; ++p) {
      const int p0 = p * kPts;
      save.tiles.pass = r * passes + p;
      if (again) {   // the tile's masks and operands; its raw heads land where they
                     // are no longer read
        mlp_tile_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                          hout + 4 * p0, hand, tile, ring, masks, save);
        __threadfence_block();   // x7's tile, before other threads read it back
        ++tile;
      }
      if (tid < kPts) gsbf[tid] = bf16_round(graw[p0 + tid]);
      rgb_head_bwd_full<D, true>(base + L.act, grgb + 4 * p0, graw + p0, mask_h, rgb_head, red,
                                 part0 + w13_at, part0 + b0_at, lay, ghsum);
      copy_rows_async(base + L.act + wg * kWgRowBytes, save.tiles.g(0) + wg * kWgRowBytes,
                      H / 64);   // g_h
      density_head_dw<D>(save.tiles, gsbf, part0);
      float dpe[32];
      dx_chain_full<D>(dpe, base + L.act, ring, masks, gsbf, dens_head, save.tiles,
                       part_wg + b0_at, red + wg * 4 * D, lay);
      tile_enc_vjp90(dpe, ray, fz, gz, rsum, red, p0);
    }

    // ---- the direction's part, once per ray: dW[12] += bf16(de)^T ghsum, dde --
    for (int e = tid; e < kDe * H; e += kConsumers) part0[w12_at + e] += de[e / H] * ghsum[e % H];
    ray_dir_vjp90<D>(w12, tiles + T::kW12, ghsum, ray, rsum, red);
    if (tid < 9) drays[r * 9 + tid] = rsum[tid];
    for (int s = tid; s < S; s += kConsumers) dz[r * S + s] = gz[s];
  }
  if (LOSS && tid < 3) part0[sums_at + tid] = cot[8 + tid];
  bulk_complete();   // every bulk copy of the CTA's operands, before it exits
}

// Bytes of the scratch of render_full_launch into sizes[0..3] (the X and G
// operands, the chain's partial sums, the dW kernel's partials per chunk of
// samples) and the dW kernel's CTA tiles into sizes[4].
inline cudaError_t render_full_scratch(int D, long long n_rays, int S, int n_ctas,
                                       long long* sizes) {
  const long long n_pass = n_rays * (S / kPts);
  if (D == 256)
    chain_scratch_sizes<256>(n_pass, n_ctas, render_seg(256), false, sizes);
  else if (D == 128)
    chain_scratch_sizes<128>(n_pass, n_ctas, render_seg(128), false, sizes);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The chain, the in-order sum of its partials and the dW kernel on
// `stream`. xops, gops, chain_part, dw_part: scratch of the sizes
// render_full_scratch gives (dw_part: chunks times its size).
template <int D, bool LOSS>
cudaError_t render_full_launch(const float* rays, const float* z, const RayCotangents& cin,
                               const unsigned char* tiles, const unsigned char* tiles_dx,
                               const Biases& bias, unsigned char* xops, unsigned char* gops,
                               float* chain_part, float* dw_part, float* grads, float* drays,
                               float* dz, int n_rays, int S, int n_ctas, int chunks,
                               const RenderFlags& fl, cudaStream_t stream) {
  const size_t area = mask_bytes<D>() + render_full_f32_bytes<D>(S);   // masks, then the f32 arrays
  const Layout90<D> L(false, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  cudaError_t err = cudaFuncSetAttribute(render_full_kernel<D, LOSS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_full_kernel<D, LOSS><<<n_ctas, kThreads90, smem, stream>>>(
      rays, z, cin, tiles, tiles_dx, bias, xops, gops, chain_part, drays, dz, n_rays, S, fl, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const GradLayout lay = grad_layout(D);
  err = chain_reduce_launch(chain_part, grads, render_seg(D), n_ctas, D, lay.w[12], stream);
  if (err != cudaSuccess) return err;
  const long long n_pass = static_cast<long long>(n_rays) * (S / kPts);
  DwTable tab = chain_dw_table<D>(xops, gops, grads, n_pass, false);
  return dw_sm90_launch(tab, n_pass * kPts, chunks, dw_part, stream);
}

// The checks both C entries make before a launch.
inline cudaError_t render_full_check(int n_rays, int S, int D, int n_ctas, int chunks, int total,
                                     const void* tiles, const void* tiles_dx, const void* xops,
                                     const void* gops) {
  if (n_rays <= 0 || n_ctas <= 0 || n_ctas > n_rays) return cudaErrorInvalidValue;
  if (S <= 0 || S % kPts != 0 || S > kMaxTrainS) return cudaErrorInvalidValue;
  if ((D != 128 && D != 256) || total != grad_layout(D).total) return cudaErrorInvalidValue;
  if (chunks <= 0 || chunks > static_cast<long long>(n_rays) * (S / kPts))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(tiles_dx) |
       reinterpret_cast<uintptr_t>(xops) | reinterpret_cast<uintptr_t>(gops)) % 16 != 0)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The gradient buffer's layout into offsets: 14 dW, 12 dB, with sums the
// loss sums' offset last; returns the buffer's length, or 0 for a width the
// kernels are not built for.
inline int render_grad_layout(int D, int* offsets, bool sums) {
  if (D != 128 && D != 256) return 0;
  const GradLayout lay = grad_layout(D);
  for (int i = 0; i < 14; ++i) offsets[i] = lay.w[i];
  for (int i = 0; i < 12; ++i) offsets[14 + i] = lay.b[i];
  if (sums) offsets[26] = lay.sums;
  return lay.total;
}

}  // namespace
