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
// Design, three launches on one stream per chunk of rays (render_full_launch):
// 1. The chain: render_bwd_frozen.cu's kernel (persistent CTAs over rays;
//    per ray the S/128 tiles through the wgmma forward, the composite
//    forward and backward over the ray, each tile back through the dX
//    chain, after a second forward for its masks when S > 128), which also
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
//    chain_dw_pieces without its direction block) over the N S samples.
// The operands take 9,600 B a sample at D = 256 (4,864 at D = 128): 5 GB for
// 1024 rays x 512 samples, 20 GB at 2048. So the rays go in consecutive
// chunks whose operands stay within a budget the caller sets
// (ops/fused_render.py::render_chunks: 2.52 GB, 1024 rays x 256 samples at
// D = 256, so that every call up to that size is one chunk), each chunk
// through the three launches on the same scratch; each chunk's dW and dB
// (and K1's loss sums) are added into the gradient buffer in chunk order.
// No float atomics: two launches give the same bits. K4 fed K1's own
// cotangents runs the same arithmetic and reproduces K1's gradients bit for
// bit, and K4's d(rays) and dz are the frozen variant's bit for bit (the
// same chain and the same per-ray pieces of mlp_dx_sm90.cuh).
//
// Shared memory at D=256: the frozen variant's (activations 64 KB, position
// encodings 16 KB, heads 6 KB, masks 34 KB) with f32 arrays of 15 KB (S=128)
// or 21 KB (S=256), 8 KB of them the per-warp bias sums, and two 32 KB ring
// stages. Any S % 128 == 0 runs: above S = 640 at D = 256 (2,688 at
// D = 128) the per-sample arrays, and above S = 1,536 (768) the
// composite's, go to the CTA's share of a scratch in device memory
// (mlp_fwd_sm90.cuh's RayPlace).
//
// At D = 384 and 512, render_full_wide_kernel takes the chain's place: the
// 64-point chain of mlp_dx_wide_sm90.cuh, as render_bwd_frozen.cu's wide
// kernel runs it (a ray is S/64 tiles; each tile's forward runs once, its
// ReLU masks kept in the CTA's scratch in device memory, the parked g4 in
// the same scratch), with mlp_dw_chain_sm90.cuh's OperandSaveW<D, true> as
// the forward's and the chain's hook: pass t of a chunk (tile t % (S/64) of
// ray t / (S/64)) writes half t % 2 of row tile t / 2 of each operand, in
// that single forward for the X operands; each dX epilogue's column sums go
// through the scratch in warp order into the warpgroup's segment. What the
// narrow kernel reads from its activation buffer after the composite, the
// wide one reads from the scratch: each tile's h, copied there after its
// forward (the composite borrows both buffers), for dW[13]
// (rgb_head_bwd_w_full<D, true>, which also forms the per-ray sum of bf16
// g_h for dW[12] and the direction's VJP in rgb_head_bwd_w's order), and x7
// from its operand tile for dW[9] (density_head_dw_w). The per-CTA scratch:
// g4 (64 x D bf16), the column sums (10 D floats), then the masks and h of
// the ray's S/64 tiles: 1.2 MB at D = 512, S = 1024. The same three launches
// per chunk of rays, the same partial sums and dW table (22 column pieces at
// 384, 21 at 512), so the same invariants: two launches give the same bits,
// K4 fed K1's cotangents gives K1's gradients, and d(rays), dz are the wide
// frozen variant's bit for bit (the hook adds stores and sums and reorders
// no sum of the chain). Shared memory is that frozen kernel's.
//
// At D = 640 to 1024, render_full_xwide_kernel takes the chain's place: the
// wide kernel's work per ray in the order, producer, forward and per-ray code
// of render_bwd_frozen.cu's xwide kernel (mlp_fwd_xwide_sm90.cuh's forward and
// mlp_dx_xwide_sm90.cuh's chain: one 64 x D activation buffer, each layer in
// passes of 128 columns staged in the CTA's scratch), with
// mlp_dw_chain_sm90.cuh's OperandSaveX<D, true> as the hook and
// rgb_head_bwd_x_full<D, true> for the rgb head. Its instances live in
// translation units of their own (render_train_xwide.cu, render_bwd_xwide.cu,
// with the C entries below), so those of 128 to 512 keep their SASS; that
// pair's header gives its invariants, what the build found and its costs.

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

// Shared bytes beside the per-sample arrays (z (S), heads (4S), graw (S),
// grgb (4S), gz (S)): the masks, then the direction encoding (32), the
// rgb-hidden bias (D/2), ghsum (D/2), reduction scratch, the ray (16), rsum
// (16), the tile's bf16 graw (128), the ray's cotangents and the CTA's loss
// sums (16).
template <int D>
size_t render_full_fixed_bytes() {
  return mask_bytes<D>() + sizeof(float) * (kDe + D / 2 + D / 2 + full_red_floats<D>() + 16 +
                                            16 + kPts + 16);
}

// The composite's five arrays borrow the activation buffer's blocks past h.
template <int D>
RayPlace full_place(int S) {
  return ray_place<D>(S, kRaySampleF32, kRayCompositeF32, render_full_fixed_bytes<D>(),
                      kPts * D * 2 - (D / 128) * kBlockBytes);
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
                   unsigned char* gops, float* chain_part, float* spill,
                   float* __restrict__ drays, float* __restrict__ dz, int n_rays, int S,
                   RenderFlags fl, Layout90<D> L, RayPlace place) {
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
  float* const f32 = reinterpret_cast<float*>(base + L.f32 + mask_bytes<D>());
  float* const past_h = reinterpret_cast<float*>(base + L.act + (H / 64) * kBlockBytes);
  const RayArrays arr = ray_arrays(place, S, f32, past_h, spill);
  float* fz = arr.samples;                              // z                      (S)
  float* hout = fz + S;                                 // rgb | raw density      (S,4)
  float* graw = hout + 4 * S;                           // raw-density cotangent  (S)
  float* grgb = graw + S;                               // raw-rgb cotangent      (S,4)
  float* gz = grgb + 4 * S;                             // dz                     (S)
  float* de = arr.fixed;                                // direction encoding     (32)
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
  float* alpha = arr.composite;
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

// ---- hidden_dim 384 and 512: the 64-point chain of mlp_dx_wide_sm90.cuh ----------

// Shared bytes beside the per-sample arrays at the wide widths (render_bwd_frozen.cu's
// wide kernel's): the direction encoding (32), the rgb-hidden bias (D/2), ghsum (D/2),
// reduction scratch (4 x D/2), the ray (16), rsum (16), the tile's bf16 graw (64), the
// ray's cotangents and the CTA's loss sums (16).
template <int D>
size_t render_full_fixed_bytes_w() {
  return sizeof(float) * (kDe + D / 2 + D / 2 + 4 * (D / 2) + 16 + 16 + kWRows + 16);
}

template <int D>
RayPlace full_place_w(int S) {
  return ray_place<D, LayoutW<D>>(S, kRaySampleF32, kRayCompositeF32,
                                  render_full_fixed_bytes_w<D>(), FwdTrunk<D>::kActBytes);
}

// One tile's h (64 x D/2 bf16, the buffer's first D/128 blocks), parked.
template <int D>
__host__ __device__ constexpr size_t h_tile_bytes_w() {
  return static_cast<size_t>(kWRows) * (D / 2) * 2;
}

// A CTA's scratch: the parked g4, the column sums, then the masks and the h of
// each of a ray's S/64 tiles.
template <int D>
__host__ __device__ size_t render_scratch_w(int S) {
  return g4_bytes_w<D>() + red_bytes_w<D, true>() +
         static_cast<size_t>(S / kWRows) * (mask_tile_bytes_w<D>() + h_tile_bytes_w<D>());
}


// The tile's h from buffer 1 to `dst` (device memory), by the consumers'
// 16-byte stores past L1. h is complete when mlp_tile_w_masks returns, and
// the next write over it follows the next tile's first consumer barrier.
template <int D>
__device__ __forceinline__ void park_h_w(const unsigned char* buf1, unsigned char* dst) {
  for (int e = threadIdx.x; e < static_cast<int>(h_tile_bytes_w<D>() / 16); e += kConsumers)
    __stcg(reinterpret_cast<int4*>(dst) + e, reinterpret_cast<const int4*>(buf1)[e]);
}

// K1 (LOSS) and K4 full at D = 384 and 512: render_full_kernel's work per ray
// on 64-point tiles. tile_bytes: one 64-column block over the chunk's row
// tiles (PassTilesW).
template <int D, bool LOSS>
__global__ void __launch_bounds__(kThreads90, 1)
render_full_wide_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                        RayCotangents cin, const unsigned char* __restrict__ tiles,
                        const unsigned char* __restrict__ tiles_dx, Biases bias,
                        unsigned char* xops, unsigned char* gops, float* chain_part,
                        unsigned char* scratch, float* spill, float* __restrict__ drays,
                        float* __restrict__ dz, int n_rays, int S, RenderFlags fl, LayoutW<D> L,
                        RayPlace place, size_t tile_bytes) {
  using T = TilesW<D>;
  constexpr int H = D / 2;
  constexpr size_t kMaskTileWords = mask_tile_bytes_w<D>() / sizeof(uint32_t);
  constexpr uint32_t kBuf = kWRows * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = setup90(smem_raw, L.bars, L.stages);
  Ring ring = make_ring(base, L.ring, L.bars, T::kFull, L.stages);
  const uint32_t head_bar = ring.full + 16 * kMaxStages;
  const uint32_t heads = smem_addr(base + L.heads);
  const Handoff hand = make_handoff(ring);
  const int passes = S / kWRows;

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    render_producer_w<D>(rays, z, tiles, tiles_dx, ring, heads, head_bar, hand, base + L.pe,
                         n_rays, S);
    return;
  }
  set_consumer_regs();

  const GradLayout lay = grad_layout(D);
  const int seg = render_seg(D);
  float* const f32 = reinterpret_cast<float*>(base + L.f32);
  float* const act = reinterpret_cast<float*>(base + L.act);
  const RayArrays arr = ray_arrays(place, S, f32, act, spill);
  float* fz = arr.samples;                              // z                      (S)
  float* hout = fz + S;                                 // rgb | raw density      (S,4)
  float* graw = hout + 4 * S;                           // raw-density cotangent  (S)
  float* grgb = graw + S;                               // raw-rgb cotangent      (S,4)
  float* gz = grgb + 4 * S;                             // dz                     (S)
  float* de = arr.fixed;                                // direction encoding     (32)
  float* debias = de + kDe;                             // rgb-hidden bias        (D/2)
  float* ghsum = debias + H;                            // sum of bf16 g_h        (D/2)
  float* red = ghsum + H;                               // scratch                (4 D/2)
  float* ray = red + 4 * H;                             // o | v | dir            (16)
  float* rsum = ray + 16;                               // d_o, d_v, d_dir        (16)
  float* gsbf = rsum + 16;                              // the tile's bf16 graw   (64)
  float* cot = gsbf + kWRows;   // g_rgb (0-2), g_dist (3), the CTA's loss sums (8-10)
  // between the forward and the backward: alpha, weights, transmittance and
  // the scan buffers (S each), in the activation buffers while they fit
  float* alpha = arr.composite;
  float* wts = alpha + S;
  float* trans = wts + S;
  float* scan0 = trans + S;
  float* scan1 = scan0 + S;
  unsigned char* own = scratch + static_cast<size_t>(blockIdx.x) * render_scratch_w<D>(S);
  unsigned char* g4 = own;
  float* red_d = reinterpret_cast<float*>(own + g4_bytes_w<D>());   // the column sums
  uint32_t* masks = reinterpret_cast<uint32_t*>(own + g4_bytes_w<D>() + red_bytes_w<D, true>());
  unsigned char* h_park = own + g4_bytes_w<D>() + red_bytes_w<D, true>() +
                          static_cast<size_t>(passes) * mask_tile_bytes_w<D>();
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  // w12 staged for the per-ray bias and dde where the activation buffers are
  // free: at the ray's start and end
  unsigned char* w12 = base + L.act;
  const uint32_t pe_s = smem_addr(base + L.pe);
  const int tid = threadIdx.x, wg = tid >> 7;
  // the segments: CTA-wide sums in the first, each warpgroup's dB in its own
  float* part0 = chain_part + static_cast<size_t>(blockIdx.x) * 2 * seg;
  const int w12_at = D, sums_at = D + (lay.sums - lay.w[12]);
  for (int e = tid; e < 2 * seg; e += kConsumers) part0[e] = 0.f;
  __threadfence_block();
  if (tid < 16) cot[tid] = 0.f;
  OperandSaveW<D, true> hook;
  hook.tiles = PassTilesW<D>{xops, gops, tile_bytes, 0};
  hook.red = red_d;
  hook.part = part0;
  hook.seg = seg;
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
    stage_w12_w<D>(w12, tiles + T::kW12);
    consumer_sync();
    for (int j = tid; j < H; j += kConsumers) {   // render_fwd.cu's order: the same bits
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kDe; ++k) {
        const bf16 wv = *reinterpret_cast<const bf16*>(w12 + swz64(j, k));
        acc = fmaf(de[k], __bfloat162float(wv), acc);
      }
      debias[j] = acc + bias.b[10][j];
    }
    consumer_sync();

    // ---- forward: every tile's raw heads, masks, X operands and h, once ------
    for (int p = 0; p < passes; ++p, ++tile) {
      hook.tiles.pass = r * passes + p;
      mlp_tile_w_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                          hout + 4 * kWRows * p, hand, tile, ring, masks + p * kMaskTileWords,
                          hook);
      park_h_w<D>(base + L.act + kBuf, h_park + p * h_tile_bytes_w<D>());
      __threadfence_block();   // x7's operand tile and h, before other threads read them back
    }
    hook.drain(wg);   // the composite borrows the buffers the forward's copies read
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
      const int p0 = p * kWRows;
      const uint32_t* tmask = masks + p * kMaskTileWords;
      hook.tiles.pass = r * passes + p;
      if (tid < kWRows) gsbf[tid] = bf16_round(graw[p0 + tid]);
      rgb_head_bwd_w_full<D, true>(base + L.act, grgb + 4 * p0, graw + p0,
                                   tmask + 8 * mask_layer_words_w<D>(), rgb_head, red_d, part0,
                                   part0 + wg * seg, h_park + p * h_tile_bytes_w<D>(), ghsum);
      density_head_dw_w<D>(hook.tiles, gsbf, part0);
      float dpe[32];
      dx_chain_w<D>(dpe, base + L.act, ring, tmask, gsbf, dens_head, g4, hook);
      tile_enc_vjp_w(dpe, ray, fz, gz, rsum, red, p0);
    }

    // ---- the direction's part, once per ray: dW[12] += bf16(de)^T ghsum, dde --
    for (int e = tid; e < kDe * H; e += kConsumers) part0[w12_at + e] += de[e / H] * ghsum[e % H];
    ray_dir_vjp_w<D>(w12, tiles + T::kW12, ghsum, ray, rsum, red);
    if (tid < 9) drays[r * 9 + tid] = rsum[tid];
    for (int s = tid; s < S; s += kConsumers) dz[r * S + s] = gz[s];
  }
  if (LOSS && tid < 3) part0[sums_at + tid] = cot[8 + tid];
  bulk_complete();   // every bulk copy of the CTA's operands, before it exits
}

// ---- hidden_dim 640 to 1024: the chain of mlp_dx_xwide_sm90.cuh -------------------

// The per-sample arrays' place past 512: render_bwd_frozen.cu's xwide kernel's
// (the same shared floats beside them, render_full_fixed_bytes_w).
template <int D>
RayPlace full_place_x(int S) {
  return ray_place<D, LayoutX<D>>(S, kRaySampleF32, kRayCompositeF32,
                                  render_full_fixed_bytes_w<D>(), TrunkX<D>::kActBytes);
}

// A CTA's scratch past 512: the parked g4, the staging of a layer's passes,
// the column sums, then the masks and the h of each of a ray's S/64 tiles.
template <int D>
__host__ __device__ size_t render_scratch_x(int S) {
  return g4_bytes_w<D>() + TilesX<D>::kStageBytes + red_bytes_w<D, true>() +
         static_cast<size_t>(S / kWRows) * (mask_tile_bytes_x<D>() + h_tile_bytes_w<D>());
}

// K1 (LOSS) and K4 full at D = 640 to 1024: render_full_wide_kernel's work per
// ray in render_bwd_frozen_xwide_kernel's order, on its producer, forward,
// chain and per-ray code: every tile's forward once (its masks, X operands
// and h parked in the scratch), the composite forward (with LOSS the loss
// rows and cotangents) and backward over the ray, then each tile's rgb head
// backward with its gradients (h from the park), dW[9], the dX chain with
// the hook and the encoding VJP; once per ray dW[12] and the direction's VJP.
// tile_bytes: one 64-column block over the chunk's row tiles (PassTilesW).
template <int D, bool LOSS>
__global__ void __launch_bounds__(kThreads90, 1)
render_full_xwide_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                         RayCotangents cin, const unsigned char* __restrict__ tiles,
                         const unsigned char* __restrict__ tiles_dx, Biases bias,
                         unsigned char* xops, unsigned char* gops, float* chain_part,
                         unsigned char* scratch, float* spill, float* __restrict__ drays,
                         float* __restrict__ dz, int n_rays, int S, RenderFlags fl, LayoutX<D> L,
                         RayPlace place, size_t tile_bytes) {
  using T = TilesX<D>;
  constexpr int H = D / 2;
  constexpr size_t kMaskTileWords = mask_tile_bytes_x<D>() / sizeof(uint32_t);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = setup90(smem_raw, L.bars, L.stages);
  Ring ring = make_ring(base, L.ring, L.bars, T::kFull, L.stages);
  const uint32_t head_bar = ring.full + 16 * kMaxStages;
  const uint32_t heads = smem_addr(base + L.heads);
  const Handoff hand = make_handoff(ring);
  const int passes = S / kWRows;

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    render_producer_x<D>(rays, z, tiles, tiles_dx, ring, heads, head_bar, hand, base + L.pe,
                         n_rays, S);
    return;
  }
  set_consumer_regs();

  const GradLayout lay = grad_layout(D);
  const int seg = render_seg(D);
  float* const f32 = reinterpret_cast<float*>(base + L.f32);
  float* const act = reinterpret_cast<float*>(base + L.act);
  const RayArrays arr = ray_arrays(place, S, f32, act, spill);
  float* fz = arr.samples;                              // z                      (S)
  float* hout = fz + S;                                 // rgb | raw density      (S,4)
  float* graw = hout + 4 * S;                           // raw-density cotangent  (S)
  float* grgb = graw + S;                               // raw-rgb cotangent      (S,4)
  float* gz = grgb + 4 * S;                             // dz                     (S)
  float* de = arr.fixed;                                // direction encoding     (32)
  float* debias = de + kDe;                             // rgb-hidden bias        (D/2)
  float* ghsum = debias + H;                            // sum of bf16 g_h        (D/2)
  float* red = ghsum + H;                               // scratch                (4 D/2)
  float* ray = red + 4 * H;                             // o | v | dir            (16)
  float* rsum = ray + 16;                               // d_o, d_v, d_dir        (16)
  float* gsbf = rsum + 16;                              // the tile's bf16 graw   (64)
  float* cot = gsbf + kWRows;   // g_rgb (0-2), g_dist (3), the CTA's loss sums (8-10)
  // between the forward and the backward: alpha, weights, transmittance and
  // the scan buffers (S each), in the activation buffer while they fit
  float* alpha = arr.composite;
  float* wts = alpha + S;
  float* trans = wts + S;
  float* scan0 = trans + S;
  float* scan1 = scan0 + S;
  unsigned char* g4 = scratch + static_cast<size_t>(blockIdx.x) * render_scratch_x<D>(S);
  unsigned char* stage = g4 + g4_bytes_w<D>();
  float* red_d = reinterpret_cast<float*>(stage + T::kStageBytes);   // the column sums
  uint32_t* masks = reinterpret_cast<uint32_t*>(stage + T::kStageBytes + red_bytes_w<D, true>());
  unsigned char* h_park = reinterpret_cast<unsigned char*>(masks) +
                          static_cast<size_t>(passes) * mask_tile_bytes_x<D>();
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  // w12 staged for the per-ray bias and dde where the activation buffer is
  // free: at the ray's start and end
  unsigned char* w12 = base + L.act;
  const uint32_t pe_s = smem_addr(base + L.pe);
  const int tid = threadIdx.x, wg = tid >> 7;
  // the segments: CTA-wide sums in the first, each warpgroup's dB in its own
  float* part0 = chain_part + static_cast<size_t>(blockIdx.x) * 2 * seg;
  const int w12_at = D, sums_at = D + (lay.sums - lay.w[12]);
  for (int e = tid; e < 2 * seg; e += kConsumers) part0[e] = 0.f;
  __threadfence_block();
  if (tid < 16) cot[tid] = 0.f;
  OperandSaveX<D, true> hook;
  hook.tiles = PassTilesW<D>{xops, gops, tile_bytes, 0};
  hook.red = red_d;
  hook.part = part0;
  hook.seg = seg;
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
    stage_w12_x<D>(w12, tiles);
    consumer_sync();
    for (int j = tid; j < H; j += kConsumers) {   // render_fwd.cu's order: the same bits
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kDe; ++k) {
        const bf16 wv = *reinterpret_cast<const bf16*>(w12 + w12_x<D>(j, k));
        acc = fmaf(de[k], __bfloat162float(wv), acc);
      }
      debias[j] = acc + bias.b[10][j];
    }
    consumer_sync();

    // ---- forward: every tile's raw heads, masks, X operands and h, once ------
    for (int p = 0; p < passes; ++p, ++tile) {
      hook.tiles.pass = r * passes + p;
      mlp_tile_x_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                          hout + 4 * kWRows * p, hand, tile, ring, masks + p * kMaskTileWords,
                          stage, hook);
      park_h_w<D>(base + L.act, h_park + p * h_tile_bytes_w<D>());   // h: the buffer's first D/2
      __threadfence_block();   // x7's operand tile and h, before other threads read them back
    }
    hook.drain(wg);   // the composite borrows the buffer the forward's copies read
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
    for (int j = tid; j < H; j += kConsumers) ghsum[j] = 0.f;   // D/2 passes 256 here
    if (tid < 16) rsum[tid] = 0.f;
    consumer_sync();

    // ---- heads -> MLP -> encoding, tile by tile -------------------------------
    for (int p = 0; p < passes; ++p) {
      const int p0 = p * kWRows;
      const uint32_t* tmask = masks + p * kMaskTileWords;
      hook.tiles.pass = r * passes + p;
      if (tid < kWRows) gsbf[tid] = bf16_round(graw[p0 + tid]);
      rgb_head_bwd_x_full<D, true>(base + L.act, grgb + 4 * p0, graw + p0,
                                   tmask + 8 * mask_layer_words_x<D>(), rgb_head, red_d, part0,
                                   part0 + wg * seg, h_park + p * h_tile_bytes_w<D>(), ghsum);
      density_head_dw_w<D>(hook.tiles, gsbf, part0);
      float dpe[32];
      dx_chain_x<D>(dpe, base + L.act, stage, ring, tmask, gsbf, dens_head, g4, hook);
      tile_enc_vjp_w(dpe, ray, fz, gz, rsum, red, p0);
    }

    // ---- the direction's part, once per ray: dW[12] += bf16(de)^T ghsum, dde --
    for (int e = tid; e < kDe * H; e += kConsumers) part0[w12_at + e] += de[e / H] * ghsum[e % H];
    stage_w12_x<D>(w12, tiles);
    consumer_sync();
    dir_vjp<H>([&](int j, int k) { return *reinterpret_cast<const bf16*>(w12 + w12_x<D>(j, k)); },
               ghsum, ray, rsum, red);
    if (tid < 9) drays[r * 9 + tid] = rsum[tid];
    for (int s = tid; s < S; s += kConsumers) dz[r * S + s] = gz[s];
  }
  if (LOSS && tid < 3) part0[sums_at + tid] = cot[8 + tid];
  bulk_complete();   // every bulk copy of the CTA's operands, before it exits
}

// The widths of a render library: 128 to 512 (render_train.cu, render_bwd.cu),
// or with XWIDE 640 to 1024 (render_train_xwide.cu, render_bwd_xwide.cu).
template <bool XWIDE>
bool full_width(int D) {
  return XWIDE ? (D == 640 || D == 768 || D == 896 || D == 1024)
               : (D == 128 || D == 256 || D == 384 || D == 512);
}

// f(std::integral_constant<int, D>()) at D, one of the library's widths
// (full_width<XWIDE>); cudaErrorInvalidValue at any other.
template <bool XWIDE, typename F>
cudaError_t at_width(int D, F&& f) {
  if constexpr (XWIDE) {
    switch (D) {
      case 640: return f(std::integral_constant<int, 640>());
      case 768: return f(std::integral_constant<int, 768>());
      case 896: return f(std::integral_constant<int, 896>());
      case 1024: return f(std::integral_constant<int, 1024>());
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 128: return f(std::integral_constant<int, 128>());
      case 256: return f(std::integral_constant<int, 256>());
      case 384: return f(std::integral_constant<int, 384>());
      case 512: return f(std::integral_constant<int, 512>());
      default: return cudaErrorInvalidValue;
    }
  }
}

// The per-ray arrays' place and the shared bytes beside them at width D: the
// narrow kernel's at 128 and 256, the wide kernel's at 384 and 512, the xwide
// kernel's past 512 (the wide kernel's shared floats).
template <int D>
RayPlace full_place_at(int S) {
  if constexpr (D > 512)
    return full_place_x<D>(S);
  else if constexpr (D > 256)
    return full_place_w<D>(S);
  else
    return full_place<D>(S);
}
template <int D>
size_t full_fixed_bytes_at() {
  if constexpr (D > 256)
    return render_full_fixed_bytes_w<D>();
  else
    return render_full_fixed_bytes<D>();
}

// Bytes of the scratch of render_full_launch for chunks of chunk_rays rays
// into sizes[0..3] (the X and G operands of one chunk, the chain's partial
// sums, the dW kernel's partials per chunk of samples), the dW kernel's CTA
// tiles over its whole table into sizes[4], the per-sample arrays' spill
// (n_ctas CTAs) into sizes[5] and, from 384 on, the 64-point chain's per-CTA
// scratch (render_scratch_w, past 512 render_scratch_x) into sizes[6] (0 at
// 128 and 256).
template <bool XWIDE>
cudaError_t render_full_scratch(int D, long long chunk_rays, int S, int n_ctas,
                                long long* sizes) {
  return at_width<XWIDE>(D, [&](auto width) {
    constexpr int W = decltype(width)::value;
    chain_scratch_sizes<W>(chunk_rays * (S / kPts), n_ctas, render_seg(W), false, sizes);
    const long long spill = full_place_at<W>(S).spill_floats(S);
    sizes[5] = static_cast<long long>(sizeof(float)) * spill * n_ctas;
    long long wide = 0;
    if constexpr (W > 512)
      wide = static_cast<long long>(render_scratch_x<W>(S));
    else if constexpr (W > 256)
      wide = static_cast<long long>(render_scratch_w<W>(S));
    sizes[6] = wide * n_ctas;
    return cudaSuccess;
  });
}

// The ray cotangents of rays [r0, ...).
inline RayCotangents cotangents_from(const RayCotangents& c, long long r0, int S) {
  RayCotangents o = c;
  if (c.tgt != nullptr) o.tgt = c.tgt + r0 * kTgt;
  if (c.dtgt != nullptr) o.dtgt = c.dtgt + r0 * kTgt;
  if (c.g_rgb != nullptr) o.g_rgb = c.g_rgb + r0 * 3;
  if (c.g_dist != nullptr) o.g_dist = c.g_dist + r0;
  if (c.g_w != nullptr) o.g_w = c.g_w + r0 * S;
  if (c.g_a != nullptr) o.g_a = c.g_a + r0 * S;
  return o;
}

// For each chunk of chunk_rays consecutive rays (the last one takes the
// rest): the chain, the in-order sum of its partials and the dW kernel on
// `stream`, the first chunk writing the gradient buffer and each later one
// adding to it. xops, gops, chain_part, dw_part, spill, scratch: scratch of
// the sizes render_full_scratch gives (dw_part: chunks times its size;
// scratch, the 64-point kernels' per-CTA g4, column sums, masks and h, past
// 512 also the staging, from 384 on only). n_ctas and chunks are those of a
// whole chunk; a shorter last chunk takes at most one CTA a ray and one dW
// chunk a row tile. Past 512 the dW kernel's table goes in two launches
// (chain_dw_launch). launches[0] counts the chain kernel's launches made,
// launches[1] the dW kernel's.
template <int D, bool LOSS>
cudaError_t render_full_launch(const float* rays, const float* z, const RayCotangents& cin,
                               const unsigned char* tiles, const unsigned char* tiles_dx,
                               const Biases& bias, unsigned char* xops, unsigned char* gops,
                               float* chain_part, float* dw_part, float* spill,
                               unsigned char* scratch, float* grads, float* drays, float* dz,
                               int n_rays, int chunk_rays, int S, int n_ctas, int chunks,
                               const RenderFlags& fl, int* launches, cudaStream_t stream) {
  constexpr bool kWide = D > 256;
  launches[0] = launches[1] = 0;
  const RayPlace place = full_place_at<D>(S);
  const size_t area = place.area(full_fixed_bytes_at<D>(), S);   // (masks,) the f32 arrays
  const std::conditional_t<(D > 512), LayoutX<D>,
                           std::conditional_t<kWide, LayoutW<D>, Layout90<D>>> L(false, area);
  if (L.stages < 2 || (kWide && scratch == nullptr)) return cudaErrorInvalidValue;
  if (place.spill_floats(S) > 0 && spill == nullptr) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  auto* kernel = [] {
    if constexpr (D > 512)
      return render_full_xwide_kernel<D, LOSS>;
    else if constexpr (D > 256)
      return render_full_wide_kernel<D, LOSS>;
    else
      return render_full_kernel<D, LOSS>;
  }();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const GradLayout lay = grad_layout(D);
  for (long long r0 = 0; r0 < n_rays; r0 += chunk_rays) {
    const int n = static_cast<int>(n_rays - r0 < chunk_rays ? n_rays - r0 : chunk_rays);
    const int ctas = n < n_ctas ? n : n_ctas;
    const bool add = r0 > 0;
    const long long n_pass = static_cast<long long>(n) * (S / kPts);   // 128-row tiles
    const RayCotangents c = cotangents_from(cin, r0, S);
    if constexpr (kWide)
      kernel<<<ctas, kThreads90, smem, stream>>>(
          rays + r0 * 9, z + r0 * S, c, tiles, tiles_dx, bias, xops, gops, chain_part, scratch,
          spill, drays + r0 * 9, dz + r0 * S, n, S, fl, L, place,
          static_cast<size_t>(n_pass) * kBlockBytes);
    else
      kernel<<<ctas, kThreads90, smem, stream>>>(rays + r0 * 9, z + r0 * S, c, tiles, tiles_dx,
                                                 bias, xops, gops, chain_part, spill,
                                                 drays + r0 * 9, dz + r0 * S, n, S, fl, L, place);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++launches[0];
    err = chain_reduce_launch(chain_part, grads, render_seg(D), ctas, D, lay.w[12], stream, add);
    if (err != cudaSuccess) return err;
    err = chain_dw_launch<D>(xops, gops, grads, n_pass, false, n_pass * kPts,
                             chunks < n_pass ? chunks : static_cast<int>(n_pass), dw_part,
                             stream, add, launches + 1);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Both C entries' launch at width D (a width render_full_check passed).
template <bool LOSS, bool XWIDE, typename... Args>
cudaError_t render_full_run(int D, Args... args) {
  return at_width<XWIDE>(D, [&](auto width) {
    return render_full_launch<decltype(width)::value, LOSS>(args...);
  });
}

// The checks both C entries make before a launch.
template <bool XWIDE>
cudaError_t render_full_check(int n_rays, int chunk_rays, int S, int D, int n_ctas, int chunks,
                              int total, const void* tiles, const void* tiles_dx,
                              const void* xops, const void* gops) {
  if (n_rays <= 0 || chunk_rays <= 0 || chunk_rays > n_rays) return cudaErrorInvalidValue;
  if (n_ctas <= 0 || n_ctas > chunk_rays) return cudaErrorInvalidValue;
  if (S <= 0 || S % kPts != 0) return cudaErrorInvalidValue;
  if (!full_width<XWIDE>(D) || total != grad_layout(D).total) return cudaErrorInvalidValue;
  if (chunks <= 0 || chunks > static_cast<long long>(chunk_rays) * (S / kPts))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(tiles_dx) |
       reinterpret_cast<uintptr_t>(xops) | reinterpret_cast<uintptr_t>(gops)) % 16 != 0)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The gradient buffer's layout into offsets: 14 dW, 12 dB, with sums the
// loss sums' offset last; returns the buffer's length, or 0 for a width the
// kernels are not built for.
template <bool XWIDE>
int render_grad_layout(int D, int* offsets, bool sums) {
  if (!full_width<XWIDE>(D)) return 0;
  const GradLayout lay = grad_layout(D);
  for (int i = 0; i < 14; ++i) offsets[i] = lay.w[i];
  for (int i = 0; i < 12; ++i) offsets[14 + i] = lay.b[i];
  if (sums) offsets[26] = lay.sums;
  return lay.total;
}

// The bodies of the C entries nerf_render_train (LOSS, K1) and nerf_render_bwd
// (K4 full) of render_train.cu and render_bwd.cu (128 to 512) and of their
// twins past 512 (XWIDE), which document the arguments.
template <bool XWIDE>
int render_train_entry(const float* rays, const float* z, const float* tgt, const void* tiles,
                       const void* tiles_dx, const void* const* biases, void* xops, void* gops,
                       float* chain_part, float* dw_part, float* spill, void* scratch,
                       float* grads, float* drays, float* dz, float* dtgt, int n_rays,
                       int chunk_rays, int S, int D, int n_ctas, int chunks, int occ_softplus,
                       int head_dist_alpha, int dist_alpha, int rgb_p, int white_bg, int total,
                       int* launches, void* stream) {
  cudaError_t err = render_full_check<XWIDE>(n_rays, chunk_rays, S, D, n_ctas, chunks, total,
                                             tiles, tiles_dx, xops, gops);
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
  err = render_full_run<true, XWIDE>(D, rays, z, cin, w, wdx, bias, xo, go, chain_part, dw_part,
                                     spill, static_cast<unsigned char*>(scratch), grads, drays,
                                     dz, n_rays, chunk_rays, S, n_ctas, chunks, fl, launches, st);
  return static_cast<int>(err);
}

template <bool XWIDE>
int render_bwd_entry(const float* rays, const float* z, const float* g_rgb, const float* g_dist,
                     const float* g_w, const float* g_a, const void* tiles, const void* tiles_dx,
                     const void* const* biases, void* xops, void* gops, float* chain_part,
                     float* dw_part, float* spill, void* scratch, float* grads, float* drays,
                     float* dz, int n_rays, int chunk_rays, int S, int D, int n_ctas, int chunks,
                     int occ_softplus, int head_dist_alpha, int dist_alpha, int total,
                     int* launches, void* stream) {
  cudaError_t err = render_full_check<XWIDE>(n_rays, chunk_rays, S, D, n_ctas, chunks, total,
                                             tiles, tiles_dx, xops, gops);
  if (err != cudaSuccess) return static_cast<int>(err);
  Biases bias;
  for (int i = 0; i < 12; ++i) bias.b[i] = static_cast<const float*>(biases[i]);
  RayCotangents cin{nullptr, nullptr, 1, 0, g_rgb, g_dist, g_w, g_a};
  const RenderFlags fl{occ_softplus, head_dist_alpha, dist_alpha};
  const auto* w = static_cast<const unsigned char*>(tiles);
  const auto* wdx = static_cast<const unsigned char*>(tiles_dx);
  auto* xo = static_cast<unsigned char*>(xops);
  auto* go = static_cast<unsigned char*>(gops);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = render_full_run<false, XWIDE>(D, rays, z, cin, w, wdx, bias, xo, go, chain_part,
                                      dw_part, spill, static_cast<unsigned char*>(scratch), grads,
                                      drays, dz, n_rays, chunk_rays, S, n_ctas, chunks, fl,
                                      launches, st);
  return static_cast<int>(err);
}

}  // namespace
