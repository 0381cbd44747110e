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
// point at D=256, against 52 bytes a sample of input and output and the
// weights once. No activation goes to device memory (mlp_dx_sm90.cuh).
//
// Design: persistent CTAs, one per SM, walk over the rays blockIdx.x,
// blockIdx.x + gridDim.x, ...; per ray the S/128 tiles go through the
// forward on the wgmma trunk (masks kept), then the composite forward and
// backward run over the ray in shared memory, then each tile goes back
// through the dX chain (after a second forward for its masks when S = 256).
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
// stages.

#include "mlp_dx_sm90.cuh"

namespace {

// f32 arrays: z (S), heads (4S), graw (S), grgb (4S), gz (S), direction
// encoding (32), rgb-hidden bias (D/2), ghsum (D/2), reduction scratch
// (kConsumers), the ray (16), rsum (16), the tile's bf16 graw (128), the
// ray's cotangents (16).
template <int D>
size_t frozen_f32_bytes(int S) {
  return sizeof(float) * (11 * static_cast<size_t>(S) + kDe + D / 2 + D / 2 + kConsumers + 16 +
                          16 + kPts + 16);
}

template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
render_bwd_frozen_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                         const float* __restrict__ g_rgb, const float* __restrict__ g_dist,
                         const float* __restrict__ g_w, const float* __restrict__ g_a,
                         const unsigned char* __restrict__ tiles,
                         const unsigned char* __restrict__ tiles_dx, Biases bias,
                         unsigned char* scratch, float* __restrict__ drays,
                         float* __restrict__ dz, int n_rays, int S, int occ_softplus,
                         int head_dist_alpha, int dist_alpha, Layout90<D> L) {
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

  float* fz = reinterpret_cast<float*>(base + L.f32 + mask_bytes<D>());   // z     (S)
  float* hout = fz + S;                                 // rgb | raw density      (S,4)
  float* graw = hout + 4 * S;                           // raw-density cotangent  (S)
  float* grgb = graw + S;                               // raw-rgb cotangent      (S,4)
  float* gz = grgb + 4 * S;                             // dz                     (S)
  float* de = gz + S;                                   // direction encoding     (32)
  float* debias = de + kDe;                             // rgb-hidden bias        (D/2)
  float* ghsum = debias + H;                            // sum of bf16 g_h        (D/2)
  float* red = ghsum + H;                               // scratch                (256)
  float* ray = red + kConsumers;                        // o | v | dir            (16)
  float* rsum = ray + 16;                               // d_o, d_v, d_dir        (16)
  float* gsbf = rsum + 16;                              // the tile's bf16 graw   (128)
  float* cot = gsbf + kPts;                             // g_rgb (0-2), g_dist    (16)
  // between the forward and the backward: alpha, weights, transmittance and
  // the scan buffers (S each) in the activation buffer
  float* alpha = reinterpret_cast<float*>(base + L.act);
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

template <int D>
cudaError_t launch_frozen(const float* rays, const float* z, const float* g_rgb,
                          const float* g_dist, const float* g_w, const float* g_a,
                          const unsigned char* tiles, const unsigned char* tiles_dx,
                          const Biases& bias, unsigned char* scratch, float* drays, float* dz,
                          int n_rays, int S, int n_ctas, int occ_softplus, int head_dist_alpha,
                          int dist_alpha, cudaStream_t stream) {
  const size_t area = mask_bytes<D>() + frozen_f32_bytes<D>(S);   // masks, then the f32 arrays
  const Layout90<D> L(false, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  cudaError_t err = cudaFuncSetAttribute(render_bwd_frozen_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_bwd_frozen_kernel<D><<<n_ctas, kThreads90, smem, stream>>>(
      rays, z, g_rgb, g_dist, g_w, g_a, tiles, tiles_dx, bias, scratch, drays, dz, n_rays, S,
      occ_softplus, head_dist_alpha, dist_alpha, L);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py.
// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, g_rgb
// (n_rays, 3), g_dist (n_rays) f32, contiguous on the device; g_w, g_a
// (n_rays, S) f32 or null (a zero cotangent); tiles: pack_tiles' forward
// weight buffer, tiles_dx: pack_tiles_dx's backward buffer (both 16-byte
// aligned); biases: 12 f32 device pointers in pack_weights' order. scratch:
// n_ctas x 128 x D bf16 (the chain's parked g4). drays (n_rays, 9), dz
// (n_rays, S) f32 (out). 0 < n_ctas <= n_rays. Returns a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int nerf_render_bwd_frozen(const float* rays, const float* z, const float* g_rgb,
                                      const float* g_dist, const float* g_w, const float* g_a,
                                      const void* tiles, const void* tiles_dx,
                                      const void* const* biases, void* scratch, float* drays,
                                      float* dz, int n_rays, int S, int D, int n_ctas,
                                      int occ_softplus, int head_dist_alpha, int dist_alpha,
                                      void* stream) {
  if (n_rays <= 0 || n_ctas <= 0 || n_ctas > n_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S % kPts != 0 || S > kMaxTrainS) return static_cast<int>(cudaErrorInvalidValue);
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
    case 256:
      err = launch_frozen<256>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, drays, dz,
                               n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha, st);
      break;
    case 128:
      err = launch_frozen<128>(rays, z, g_rgb, g_dist, g_w, g_a, w, wdx, bias, sc, drays, dz,
                               n_rays, S, n_ctas, occ_softplus, head_dist_alpha, dist_alpha, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
