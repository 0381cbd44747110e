// The render backward for a frozen network on Hopper (sm_90a): K4's
// frozen-network variant, d(rays) and dz only, on the wgmma dX chain of
// mlp_dx_sm90.cuh.
//
// Replaces, for a network that takes no gradient, the TPU kernel
// nope_nerf_tpu/ops/pallas_render.py::_render_bwd_kernel (reached through
// _raw_render_bwd, the VJP of render_rays_fused). Test-time pose optimisation
// freezes the network: each step needs the gradient of the ray table only,
// which carries the pose's. What it computes is the full variant's d(rays)
// and dz (render_full_sm90.cuh, K4 full), bit for bit: per ray, the forward (raw heads,
// alpha, the f32 composite), the composite backward in f32 (g_w, the
// exclusive suffix scan of g_w w, g_alpha, the dist_alpha g_delta terms),
// the head VJPs, the MLP's dX chain, the encoding VJP to the origin, the ray
// vector and z, and the direction encoding's VJP through the per-ray sum of
// the rgb-hidden cotangents. Inputs: rays (N,9), z (N,S), the cotangents of
// the rays' rgb (N,3) and dist (N,), and optionally of the weights and alpha
// (N,S). Outputs: d(rays) (N,9), dz (N,S).
//
// Bound: compute. Forward + dX are two products per layer, 2.36 MFLOP a
// point at D=256 (5.21 at 384, 9.18 at 512, 14.3 at 640, 36.2 at 1024),
// against 52 bytes a sample of input and output and the weights once. No
// activation goes to device memory (mlp_dx_sm90.cuh); from 384 on the ReLU
// masks and g4 do, to a per-CTA scratch that L2 keeps, and past 512 the
// staged passes of a layer.
//
// Design: persistent CTAs, one per SM, walk over the rays blockIdx.x,
// blockIdx.x + gridDim.x, ...; per ray the S/128 tiles go through the
// forward on the wgmma trunk (masks kept), then the composite forward and
// backward run over the ray, then each tile goes back through the dX chain
// (after a second forward for its masks when the ray has more than one).
// The producer warpgroup streams the forward and backward weight slices in
// that order and encodes every tile's sample positions ahead of the
// consumers. The per-ray sums (d_o, d_v, the direction's) are taken over the
// tiles in order. The producer, the composite forward and backward and the
// encoding VJPs are mlp_dx_sm90.cuh's, shared with the full variant.
//
// Shared memory at D=256, S=128 (the pose-opt path): activations 64 KB,
// position encodings 16 KB, heads 6 KB, masks 34 KB, f32 arrays 8.3 KB
// (alpha, weights, transmittance and the two scan buffers borrow the
// activation buffer between the forward and the backward), three 32 KB ring
// stages. Any S % 128 == 0 runs: above S = 896 at D = 256 (2,816 at
// D = 128) the per-sample arrays, and above S = 3,200 (1,536) the
// composite's, go to the CTA's share of a scratch in device memory
// (mlp_fwd_sm90.cuh's RayPlace).
//
// At D = 384 and 512, render_bwd_frozen_wide_kernel runs the 64-point chain
// of mlp_dx_wide_sm90.cuh: a ray of S samples is S/64 tiles, whose forwards
// run once, each tile's ReLU masks kept in the CTA's scratch in device
// memory (26 KB a tile at 384, 34 KB at 512, after the parked g4 of 48 or
// 64 KB), so no tile runs its forward twice. Shared memory at D = 512, S =
// 128: activations 2 x 64 KB, position encodings 8 KB, heads 12 KB, f32
// arrays 12.1 KB (the samples' 5.5 KB, the fixed 6.6 KB with rgb_head_bwd_w's
// 4 KB of column sums), two 32 KB ring stages; the per-sample arrays go to
// the spill scratch above S = 128, the composite's above S = 6,528. At
// D = 384, S = 128: 96 + 8 + 9 KB, f32 10.6 KB and four 24 KB stages; the
// per-sample arrays spill above S = 1,280, the composite's above 4,864.
//
// At D = 640 to 1024, render_bwd_frozen_xwide_kernel runs the same order on
// mlp_dx_xwide_sm90.cuh's chain: one 64 x D buffer, each layer (forward and
// dX) in passes of 128 columns, all but the last staged in the CTA's scratch,
// which holds g4 (64 x D bf16), the staging (64 x (D - 128)) and the masks of
// the ray's S/64 tiles (9 x D/128 KB each): 384 KB at 1024 and S = 128.
// Shared memory at 1024, S = 128: activations 128 KB, position encodings 8
// KB, heads 24 KB, f32 arrays 18.1 KB (the samples' 5.5 KB, the fixed 12.6
// KB), two 16 KB ring stages; the per-sample arrays spill above S = 384, the
// composite's above 6,528. w12 (D/128 slices of 8 KB) is staged in the
// activation buffer between rays.

#include "mlp_dx_xwide_sm90.cuh"

namespace {

// Shared bytes beside the per-sample arrays (z (S), heads (4S), graw (S),
// grgb (4S), gz (S)): the masks, then the direction encoding (32), the
// rgb-hidden bias (D/2), ghsum (D/2), reduction scratch (kConsumers), the
// ray (16), rsum (16), the tile's bf16 graw (128), the ray's cotangents (16).
template <int D>
size_t frozen_fixed_bytes() {
  return mask_bytes<D>() +
         sizeof(float) * (kDe + D / 2 + D / 2 + kConsumers + 16 + 16 + kPts + 16);
}

// The composite's five arrays (alpha, weights, transmittance, two scan
// buffers) borrow the whole activation buffer.
template <int D>
RayPlace frozen_place(int S) {
  return ray_place<D>(S, kRaySampleF32, kRayCompositeF32, frozen_fixed_bytes<D>(), kPts * D * 2);
}

// Built twice: SPILL false for the sizes where the ray's arrays fit in shared
// memory (plain addresses, the register allocation those sizes were tuned
// with), SPILL true past them (the addresses from ray_arrays).
template <int D, bool SPILL>
__global__ void __launch_bounds__(kThreads90, 1)
render_bwd_frozen_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                         const float* __restrict__ g_rgb, const float* __restrict__ g_dist,
                         const float* __restrict__ g_w, const float* __restrict__ g_a,
                         const unsigned char* __restrict__ tiles,
                         const unsigned char* __restrict__ tiles_dx, Biases bias,
                         unsigned char* scratch, float* spill, float* __restrict__ drays,
                         float* __restrict__ dz, int n_rays, int S, int occ_softplus,
                         int head_dist_alpha, int dist_alpha, Layout90<D> L, RayPlace place) {
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

  float* const f32 = reinterpret_cast<float*>(base + L.f32 + mask_bytes<D>());
  float* const act = reinterpret_cast<float*>(base + L.act);
  const RayArrays arr = ray_arrays(place, S, f32, act, spill);   // read with SPILL only
  float* fz = SPILL ? arr.samples : f32;                // z                      (S)
  float* hout = fz + S;                                 // rgb | raw density      (S,4)
  float* graw = hout + 4 * S;                           // raw-density cotangent  (S)
  float* grgb = graw + S;                               // raw-rgb cotangent      (S,4)
  float* gz = grgb + 4 * S;                             // dz                     (S)
  float* de = SPILL ? arr.fixed : gz + S;               // direction encoding     (32)
  float* debias = de + kDe;                             // rgb-hidden bias        (D/2)
  float* ghsum = debias + H;                            // sum of bf16 g_h        (D/2)
  float* red = ghsum + H;                               // scratch                (256)
  float* ray = red + kConsumers;                        // o | v | dir            (16)
  float* rsum = ray + 16;                               // d_o, d_v, d_dir        (16)
  float* gsbf = rsum + 16;                              // the tile's bf16 graw   (128)
  float* cot = gsbf + kPts;                             // g_rgb (0-2), g_dist    (16)
  // between the forward and the backward: alpha, weights, transmittance and
  // the scan buffers (S each) in the activation buffer
  float* alpha = SPILL ? arr.composite : act;
  float* wts = alpha + S;
  float* trans = wts + S;
  float* scan0 = trans + S;
  float* scan1 = scan0 + S;
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + L.f32);
  const uint32_t* mask_h = masks + 8 * mask_layer_words<D>();
  unsigned char* save = scratch + static_cast<size_t>(blockIdx.x) * kPts * D * 2;
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  // w12 (the rgb-hidden layer's direction part) staged for the per-ray bias
  // and dde, where the activation buffer is free: at the ray's start and end
  unsigned char* w12 = base + L.act;
  const uint32_t pe_s = smem_addr(base + L.pe);
  const int tid = threadIdx.x;
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
    consumer_sync();   // the previous ray is done with every buffer
    if (tid < 9) ray[tid] = rays[r * 9 + tid];
    if (tid < 3) cot[tid] = g_rgb[r * 3 + tid];
    if (tid == 3) cot[3] = g_dist[r];
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

    // ---- forward: every tile's raw heads (and the masks of the last) ----------
    for (int p0 = 0; p0 < S; p0 += kPts, ++tile)
      mlp_tile_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                        hout + 4 * p0, hand, tile, ring, masks);
    consumer_sync();
    composite_fwd90(hout, fz, alpha, trans, wts, scan0, scan1, S, occ_softplus, head_dist_alpha,
                    dist_alpha);

    // ---- composite backward (f32) ---------------------------------------------
    composite_bwd90(cot, cot[3], 0, g_w == nullptr ? nullptr : g_w + r * S,
                    g_a == nullptr ? nullptr : g_a + r * S, hout, fz, alpha, trans, wts, scan0,
                    scan1, graw, grgb, gz, S, occ_softplus, head_dist_alpha, dist_alpha);
    if (tid < H) ghsum[tid] = 0.f;
    if (tid < 16) rsum[tid] = 0.f;
    consumer_sync();

    // ---- heads -> MLP -> encoding, tile by tile -------------------------------
    for (int p0 = 0; p0 < S; p0 += kPts) {
      if (again) {   // the tile's masks; its raw heads land where they are no longer read
        mlp_tile_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                          hout + 4 * p0, hand, tile, ring, masks);
        ++tile;
      }
      if (tid < kPts) gsbf[tid] = bf16_round(graw[p0 + tid]);
      rgb_head_bwd<D>(base + L.act, grgb + 4 * p0, mask_h, rgb_head, red, ghsum);
      float dpe[32];
      dx_chain<D>(dpe, base + L.act, ring, masks, gsbf, dens_head, save);

      tile_enc_vjp90(dpe, ray, fz, gz, rsum, red, p0);
    }

    // ---- direction encoding, once per ray: dde = (sum_s bf16 g_h) wrde^T -----
    ray_dir_vjp90<D>(w12, tiles + T::kW12, ghsum, ray, rsum, red);
    if (tid < 9) drays[r * 9 + tid] = rsum[tid];
    for (int s = tid; s < S; s += kConsumers) dz[r * S + s] = gz[s];
  }
}

// ---- hidden_dim 384 and 512: the 64-point tiles of mlp_dx_wide_sm90.cuh -------

// Shared bytes beside the per-sample arrays at the wide widths: the direction
// encoding (32), the rgb-hidden bias (D/2), ghsum (D/2), reduction scratch
// (4 x D/2: rgb_head_bwd_w's per-warp column sums), the ray (16), rsum (16),
// the tile's bf16 graw (64), the ray's cotangents (16).
template <int D>
size_t frozen_fixed_bytes_w() {
  return sizeof(float) * (kDe + D / 2 + D / 2 + 4 * (D / 2) + 16 + 16 + kWRows + 16);
}

template <int D>
RayPlace frozen_place_w(int S) {
  return ray_place<D, LayoutW<D>>(S, kRaySampleF32, kRayCompositeF32, frozen_fixed_bytes_w<D>(),
                                  FwdTrunk<D>::kActBytes);
}

// A CTA's scratch at the wide widths: g4's parked copy, then the masks of
// every tile of a ray.
template <int D>
__host__ __device__ size_t frozen_scratch_w(int S) {
  return g4_bytes_w<D>() + static_cast<size_t>(S / kWRows) * mask_tile_bytes_w<D>();
}

// K4's frozen variant at D = 384 and 512, on 64-point tiles: per ray, every
// tile's forward with its masks kept in the CTA's scratch, the composite
// forward and backward over the ray, then each tile's rgb head backward, dX
// chain and encoding VJP. Its per-sample arrays are placed by RayPlace at run
// time (one build per width).
template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
render_bwd_frozen_wide_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                              const float* __restrict__ g_rgb, const float* __restrict__ g_dist,
                              const float* __restrict__ g_w, const float* __restrict__ g_a,
                              const unsigned char* __restrict__ tiles,
                              const unsigned char* __restrict__ tiles_dx, Biases bias,
                              unsigned char* scratch, float* spill, float* __restrict__ drays,
                              float* __restrict__ dz, int n_rays, int S, int occ_softplus,
                              int head_dist_alpha, int dist_alpha, LayoutW<D> L, RayPlace place) {
  using T = TilesW<D>;
  constexpr int H = D / 2;
  constexpr size_t kMaskTileWords = mask_tile_bytes_w<D>() / sizeof(uint32_t);
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
  float* cot = gsbf + kWRows;                           // g_rgb (0-2), g_dist    (16)
  // between the forward and the backward: alpha, weights, transmittance and
  // the scan buffers (S each), in the activation buffers while they fit
  float* alpha = arr.composite;
  float* wts = alpha + S;
  float* trans = wts + S;
  float* scan0 = trans + S;
  float* scan1 = scan0 + S;
  unsigned char* save = scratch + static_cast<size_t>(blockIdx.x) * frozen_scratch_w<D>(S);
  uint32_t* masks = reinterpret_cast<uint32_t*>(save + g4_bytes_w<D>());
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  // w12 staged for the per-ray bias and dde where the activation buffers are
  // free: at the ray's start and end
  unsigned char* w12 = base + L.act;
  const uint32_t pe_s = smem_addr(base + L.pe);
  const int tid = threadIdx.x;
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
    consumer_sync();   // the previous ray is done with every buffer
    if (tid < 9) ray[tid] = rays[r * 9 + tid];
    if (tid < 3) cot[tid] = g_rgb[r * 3 + tid];
    if (tid == 3) cot[3] = g_dist[r];
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

    // ---- forward: every tile's raw heads, its masks kept --------------------
    for (int p = 0; p < passes; ++p, ++tile)
      mlp_tile_w_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                          hout + 4 * kWRows * p, hand, tile, ring, masks + p * kMaskTileWords);
    consumer_sync();
    composite_fwd90(hout, fz, alpha, trans, wts, scan0, scan1, S, occ_softplus, head_dist_alpha,
                    dist_alpha);

    // ---- composite backward (f32) ---------------------------------------------
    composite_bwd90(cot, cot[3], 0, g_w == nullptr ? nullptr : g_w + r * S,
                    g_a == nullptr ? nullptr : g_a + r * S, hout, fz, alpha, trans, wts, scan0,
                    scan1, graw, grgb, gz, S, occ_softplus, head_dist_alpha, dist_alpha);
    if (tid < H) ghsum[tid] = 0.f;
    if (tid < 16) rsum[tid] = 0.f;
    consumer_sync();

    // ---- heads -> MLP -> encoding, tile by tile -------------------------------
    for (int p = 0; p < passes; ++p) {
      const int p0 = p * kWRows;
      const uint32_t* tmask = masks + p * kMaskTileWords;
      if (tid < kWRows) gsbf[tid] = bf16_round(graw[p0 + tid]);
      rgb_head_bwd_w<D>(base + L.act, grgb + 4 * p0, tmask + 8 * mask_layer_words_w<D>(),
                        rgb_head, red, ghsum);
      float dpe[32];
      dx_chain_w<D>(dpe, base + L.act, ring, tmask, gsbf, dens_head, save);
      tile_enc_vjp_w(dpe, ray, fz, gz, rsum, red, p0);
    }

    // ---- direction encoding, once per ray: dde = (sum_s bf16 g_h) wrde^T -----
    ray_dir_vjp_w<D>(w12, tiles + T::kW12, ghsum, ray, rsum, red);
    if (tid < 9) drays[r * 9 + tid] = rsum[tid];
    for (int s = tid; s < S; s += kConsumers) dz[r * S + s] = gz[s];
  }
}

// ---- hidden_dim 640 to 1024: the 64-point tiles of mlp_dx_xwide_sm90.cuh --------

template <int D>
RayPlace frozen_place_x(int S) {
  return ray_place<D, LayoutX<D>>(S, kRaySampleF32, kRayCompositeF32, frozen_fixed_bytes_w<D>(),
                                  TrunkX<D>::kActBytes);
}

// A CTA's scratch past 512: g4's parked copy, the staging of the forward's
// and the chain's passes, then the masks of every tile of a ray.
template <int D>
__host__ __device__ size_t frozen_scratch_x(int S) {
  return g4_bytes_w<D>() + TilesX<D>::kStageBytes +
         static_cast<size_t>(S / kWRows) * mask_tile_bytes_x<D>();
}

// K4's frozen variant at D = 640 to 1024: render_bwd_frozen_wide_kernel's
// order on mlp_fwd_xwide_sm90.cuh's forward and mlp_dx_xwide_sm90.cuh's chain
// (one activation buffer; each layer in passes of 128 columns, staged).
template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
render_bwd_frozen_xwide_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                               const float* __restrict__ g_rgb, const float* __restrict__ g_dist,
                               const float* __restrict__ g_w, const float* __restrict__ g_a,
                               const unsigned char* __restrict__ tiles,
                               const unsigned char* __restrict__ tiles_dx, Biases bias,
                               unsigned char* scratch, float* spill, float* __restrict__ drays,
                               float* __restrict__ dz, int n_rays, int S, int occ_softplus,
                               int head_dist_alpha, int dist_alpha, LayoutX<D> L, RayPlace place) {
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
  float* cot = gsbf + kWRows;                           // g_rgb (0-2), g_dist    (16)
  // between the forward and the backward: alpha, weights, transmittance and
  // the scan buffers (S each), in the activation buffer while they fit
  float* alpha = arr.composite;
  float* wts = alpha + S;
  float* trans = wts + S;
  float* scan0 = trans + S;
  float* scan1 = scan0 + S;
  unsigned char* g4 = scratch + static_cast<size_t>(blockIdx.x) * frozen_scratch_x<D>(S);
  unsigned char* stage = g4 + g4_bytes_w<D>();
  uint32_t* masks = reinterpret_cast<uint32_t*>(stage + T::kStageBytes);
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  // w12 staged for the per-ray bias and dde where the activation buffer is
  // free: at the ray's start and end
  unsigned char* w12 = base + L.act;
  const uint32_t pe_s = smem_addr(base + L.pe);
  const int tid = threadIdx.x;
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
    consumer_sync();   // the previous ray is done with every buffer
    if (tid < 9) ray[tid] = rays[r * 9 + tid];
    if (tid < 3) cot[tid] = g_rgb[r * 3 + tid];
    if (tid == 3) cot[3] = g_dist[r];
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

    // ---- forward: every tile's raw heads, its masks kept --------------------
    for (int p = 0; p < passes; ++p, ++tile)
      mlp_tile_x_masks<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                          hout + 4 * kWRows * p, hand, tile, ring, masks + p * kMaskTileWords,
                          stage);
    consumer_sync();
    composite_fwd90(hout, fz, alpha, trans, wts, scan0, scan1, S, occ_softplus, head_dist_alpha,
                    dist_alpha);

    // ---- composite backward (f32) ---------------------------------------------
    composite_bwd90(cot, cot[3], 0, g_w == nullptr ? nullptr : g_w + r * S,
                    g_a == nullptr ? nullptr : g_a + r * S, hout, fz, alpha, trans, wts, scan0,
                    scan1, graw, grgb, gz, S, occ_softplus, head_dist_alpha, dist_alpha);
    for (int j = tid; j < H; j += kConsumers) ghsum[j] = 0.f;   // D/2 passes 256 here
    if (tid < 16) rsum[tid] = 0.f;
    consumer_sync();

    // ---- heads -> MLP -> encoding, tile by tile -------------------------------
    for (int p = 0; p < passes; ++p) {
      const int p0 = p * kWRows;
      const uint32_t* tmask = masks + p * kMaskTileWords;
      if (tid < kWRows) gsbf[tid] = bf16_round(graw[p0 + tid]);
      rgb_head_bwd_x<D>(base + L.act, grgb + 4 * p0, tmask + 8 * mask_layer_words_x<D>(),
                        rgb_head, red, ghsum);
      float dpe[32];
      dx_chain_x<D>(dpe, base + L.act, stage, ring, tmask, gsbf, dens_head, g4);
      tile_enc_vjp_w(dpe, ray, fz, gz, rsum, red, p0);
    }

    // ---- direction encoding, once per ray: dde = (sum_s bf16 g_h) wrde^T -----
    stage_w12_x<D>(w12, tiles);
    consumer_sync();
    dir_vjp<H>([&](int j, int k) { return *reinterpret_cast<const bf16*>(w12 + w12_x<D>(j, k)); },
               ghsum, ray, rsum, red);
    if (tid < 9) drays[r * 9 + tid] = rsum[tid];
    for (int s = tid; s < S; s += kConsumers) dz[r * S + s] = gz[s];
  }
}

template <int D>
cudaError_t launch_frozen_x(const float* rays, const float* z, const float* g_rgb,
                            const float* g_dist, const float* g_w, const float* g_a,
                            const unsigned char* tiles, const unsigned char* tiles_dx,
                            const Biases& bias, unsigned char* scratch, float* spill,
                            float* drays, float* dz, int n_rays, int S, int n_ctas,
                            int occ_softplus, int head_dist_alpha, int dist_alpha,
                            cudaStream_t stream) {
  const RayPlace place = frozen_place_x<D>(S);
  const size_t area = place.area(frozen_fixed_bytes_w<D>(), S);
  const LayoutX<D> L(false, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  if (place.spill_floats(S) > 0 && spill == nullptr) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  cudaError_t err = cudaFuncSetAttribute(render_bwd_frozen_xwide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_bwd_frozen_xwide_kernel<D><<<n_ctas, kThreads90, smem, stream>>>(
      rays, z, g_rgb, g_dist, g_w, g_a, tiles, tiles_dx, bias, scratch, spill, drays, dz, n_rays,
      S, occ_softplus, head_dist_alpha, dist_alpha, L, place);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_frozen_w(const float* rays, const float* z, const float* g_rgb,
                            const float* g_dist, const float* g_w, const float* g_a,
                            const unsigned char* tiles, const unsigned char* tiles_dx,
                            const Biases& bias, unsigned char* scratch, float* spill,
                            float* drays, float* dz, int n_rays, int S, int n_ctas,
                            int occ_softplus, int head_dist_alpha, int dist_alpha,
                            cudaStream_t stream) {
  const RayPlace place = frozen_place_w<D>(S);
  const size_t area = place.area(frozen_fixed_bytes_w<D>(), S);
  const LayoutW<D> L(false, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  if (place.spill_floats(S) > 0 && spill == nullptr) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  cudaError_t err = cudaFuncSetAttribute(render_bwd_frozen_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_bwd_frozen_wide_kernel<D><<<n_ctas, kThreads90, smem, stream>>>(
      rays, z, g_rgb, g_dist, g_w, g_a, tiles, tiles_dx, bias, scratch, spill, drays, dz, n_rays,
      S, occ_softplus, head_dist_alpha, dist_alpha, L, place);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_frozen(const float* rays, const float* z, const float* g_rgb,
                          const float* g_dist, const float* g_w, const float* g_a,
                          const unsigned char* tiles, const unsigned char* tiles_dx,
                          const Biases& bias, unsigned char* scratch, float* spill, float* drays,
                          float* dz, int n_rays, int S, int n_ctas, int occ_softplus,
                          int head_dist_alpha, int dist_alpha, cudaStream_t stream) {
  const RayPlace place = frozen_place<D>(S);
  const size_t area = place.area(frozen_fixed_bytes<D>(), S);   // masks, then the f32 arrays
  const Layout90<D> L(false, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  if (place.spill_floats(S) > 0 && spill == nullptr) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  auto* kernel = place.spills(S) ? render_bwd_frozen_kernel<D, true>
                                 : render_bwd_frozen_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_ctas, kThreads90, smem, stream>>>(rays, z, g_rgb, g_dist, g_w, g_a, tiles, tiles_dx,
                                               bias, scratch, spill, drays, dz, n_rays, S,
                                               occ_softplus, head_dist_alpha, dist_alpha, L,
                                               place);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py.
// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, g_rgb
// (n_rays, 3), g_dist (n_rays) f32, contiguous on the device; g_w, g_a
// (n_rays, S) f32 or null (a zero cotangent); tiles: pack_tiles' forward
// weight buffer, tiles_dx: pack_tiles_dx's backward buffer (both 16-byte
// aligned); biases: 12 f32 device pointers in pack_weights' order. scratch:
// the bytes nerf_render_bwd_frozen_scratch gives (the chain's parked g4, from
// 384 on the masks, past 512 the staging); spill: the bytes
// nerf_render_bwd_frozen_spill gives (null where it gives 0). drays
// (n_rays, 9), dz (n_rays, S) f32 (out). 0 < n_ctas <= n_rays. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int nerf_render_bwd_frozen(const float* rays, const float* z, const float* g_rgb,
                                      const float* g_dist, const float* g_w, const float* g_a,
                                      const void* tiles, const void* tiles_dx,
                                      const void* const* biases, void* scratch, float* spill,
                                      float* drays, float* dz, int n_rays, int S, int D, int n_ctas,
                                      int occ_softplus, int head_dist_alpha, int dist_alpha,
                                      void* stream) {
  if (n_rays <= 0 || n_ctas <= 0 || n_ctas > n_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S % kPts != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0 || reinterpret_cast<uintptr_t>(tiles_dx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Biases bias;
  for (int i = 0; i < 12; ++i) bias.b[i] = static_cast<const float*>(biases[i]);
  const auto* w = static_cast<const unsigned char*>(tiles);
  const auto* wdx = static_cast<const unsigned char*>(tiles_dx);
  auto* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 1024:
      err = launch_frozen_x<1024>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, spill, drays,
                                  dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha,
                                  st);
      break;
    case 896:
      err = launch_frozen_x<896>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, spill, drays,
                                 dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha,
                                 st);
      break;
    case 768:
      err = launch_frozen_x<768>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, spill, drays,
                                 dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha,
                                 st);
      break;
    case 640:
      err = launch_frozen_x<640>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, spill, drays,
                                 dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha,
                                 st);
      break;
    case 512:
      err = launch_frozen_w<512>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, spill, drays,
                                 dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha,
                                 st);
      break;
    case 384:
      err = launch_frozen_w<384>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, spill, drays,
                                 dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha,
                                 st);
      break;
    case 256:
      err = launch_frozen<256>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, spill, drays,
                               dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha,
                               st);
      break;
    case 128:
      err = launch_frozen<128>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, spill, drays,
                               dz, n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha,
                               st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Bytes of nerf_render_bwd_frozen's spill scratch for S samples at width D
// over n_ctas CTAs (0 where every per-sample array fits in shared memory:
// every S <= 896 at D = 256); -1 for a width or an S the kernel does not take.
extern "C" long long nerf_render_bwd_frozen_spill(int S, int D, int n_ctas) {
  if (S <= 0 || S % kPts != 0 || n_ctas <= 0) return -1;
  long long per_cta;
  switch (D) {
    case 1024:
      per_cta = frozen_place_x<1024>(S).spill_floats(S);
      break;
    case 896:
      per_cta = frozen_place_x<896>(S).spill_floats(S);
      break;
    case 768:
      per_cta = frozen_place_x<768>(S).spill_floats(S);
      break;
    case 640:
      per_cta = frozen_place_x<640>(S).spill_floats(S);
      break;
    case 512:
      per_cta = frozen_place_w<512>(S).spill_floats(S);
      break;
    case 384:
      per_cta = frozen_place_w<384>(S).spill_floats(S);
      break;
    case 256:
      per_cta = frozen_place<256>(S).spill_floats(S);
      break;
    case 128:
      per_cta = frozen_place<128>(S).spill_floats(S);
      break;
    default:
      return -1;
  }
  return static_cast<long long>(sizeof(float)) * per_cta * n_ctas;
}

// Bytes of nerf_render_bwd_frozen's scratch for S samples at width D over
// n_ctas CTAs: each CTA's parked g4 (128 x D bf16 at D = 128 and 256; 64 x D
// from 384 on, followed past 512 by the staging of 64 x (D - 128) bf16, then
// by the ReLU masks of the ray's S/64 tiles); -1 for a width or an S the
// kernel does not take.
extern "C" long long nerf_render_bwd_frozen_scratch(int S, int D, int n_ctas) {
  if (S <= 0 || S % kPts != 0 || n_ctas <= 0) return -1;
  long long per_cta;
  switch (D) {
    case 1024:
      per_cta = static_cast<long long>(frozen_scratch_x<1024>(S));
      break;
    case 896:
      per_cta = static_cast<long long>(frozen_scratch_x<896>(S));
      break;
    case 768:
      per_cta = static_cast<long long>(frozen_scratch_x<768>(S));
      break;
    case 640:
      per_cta = static_cast<long long>(frozen_scratch_x<640>(S));
      break;
    case 512:
      per_cta = static_cast<long long>(frozen_scratch_w<512>(S));
      break;
    case 384:
      per_cta = static_cast<long long>(frozen_scratch_w<384>(S));
      break;
    case 256:
    case 128:
      per_cta = static_cast<long long>(kPts) * D * 2;
      break;
    default:
      return -1;
  }
  return per_cta * n_ctas;
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
