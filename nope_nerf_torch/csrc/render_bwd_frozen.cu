// The render backward for a frozen network on Hopper (sm_90a): K4's
// frozen-network variant, d(rays) and dz only, on the wgmma dX chain of
// mlp_dx_sm90.cuh.
//
// Replaces, for a network that takes no gradient, the TPU kernel
// nope_nerf_tpu/ops/pallas_render.py::_render_bwd_kernel (reached through
// _raw_render_bwd, the VJP of render_rays_fused). Test-time pose optimisation
// freezes the network: each step needs the gradient of the ray table only,
// which carries the pose's. What it computes is render_bwd.cu's full variant
// without the dW/dB products, bit for bit: per ray, the forward (raw heads,
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
// tiles in order, as the full variant's.
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

// render_fwd.cu's alpha_and_prefix90 (nerf_mlp.cuh's alpha_and_prefix over
// the consumer threads): alpha, then the f32 exclusive Hillis-Steele prefix
// sum of log(1 - alpha + eps). Returns the buffer holding the prefix sums.
__device__ __forceinline__ float* alpha_prefix90(const float* hout, const float* fz, float* alpha,
                                                 float* scan0, float* scan1, int S,
                                                 int occ_softplus, int head_dist_alpha,
                                                 int dist_alpha) {
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += kConsumers) {
    const float sigma = density_act(hout[4 * s + 3], occ_softplus);
    const float occ = head_dist_alpha ? sigma : 1.f - expf(-sigma);
    float a = occ;
    if (dist_alpha) a = (s == S - 1) ? 1.f : 1.f - expf(-occ * (fz[s + 1] - fz[s]));
    alpha[s] = a;
  }
  consumer_sync();
  for (int s = tid; s < S; s += kConsumers)
    scan0[s] = s >= 1 ? logf(1.f - alpha[s - 1] + kEps) : 0.f;
  consumer_sync();
  float* src = scan0;
  float* dst = scan1;
  for (int d = 1; d < S; d <<= 1) {
    for (int s = tid; s < S; s += kConsumers) dst[s] = s >= d ? src[s] + src[s - d] : src[s];
    consumer_sync();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

// The consumer threads copy the forward buffer's w12 slice (D/2 rows of 128
// bytes, swizzled, 32 live columns) from device memory to `dst` in shared
// memory: a few 16-byte loads a thread in flight at once, where a chain of
// fmaf over single loads would wait on L2 once per term. The loads pass L1
// by (ld.global.cg), which keeps the forward's biases.
template <int D>
__device__ __forceinline__ void stage_w12(unsigned char* dst, const unsigned char* src) {
  for (int e = threadIdx.x; e < D / 2 * 128 / 16; e += kConsumers)
    reinterpret_cast<uint4*>(dst)[e] = __ldcg(reinterpret_cast<const uint4*>(src) + e);
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
    const long long mine = (n_rays - static_cast<long long>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
    const int etid = threadIdx.x - kConsumers - 32;
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
      bulk_load(heads, tiles + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
      Feeder f{ring};
      for (long long r = 0; r < mine; ++r) {
        for (int p = 0; p < passes; ++p) f.forward<D>(tiles, T::kRender);
        for (int p = 0; p < passes; ++p) {
          if (again) f.forward<D>(tiles, T::kRender);
          f.backward<D, false>(tiles_dx);
        }
      }
    } else if (etid >= 0) {
      // encoders: the position encodings of every forward tile in the
      // consumers' order, o + v*z by explicitly rounded mul and add
      unsigned char* pe = base + L.pe;
      long long tile = 0;
      for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
        float o[3], v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o[c] = rays[r * 9 + c];
          v[c] = rays[r * 9 + 3 + c];
        }
        for (int k = 0; k < (again ? 2 : 1) * passes; ++k, ++tile) {
          wait_free(hand.pe_free, tile);
          const float* zt = z + r * S + (k % passes) * kPts;
          encode_tile<10, kPe>(pe, etid, [&](int p, int c) {
            const float oc = c == 0 ? o[0] : (c == 1 ? o[1] : o[2]);
            const float vc = c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
            return __fadd_rn(oc, __fmul_rn(vc, zt[p]));
          });
          hand_over(hand.pe_full);
        }
      }
    }
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
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
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
    const float* pre = alpha_prefix90(hout, fz, alpha, scan0, scan1, S, occ_softplus,
                                      head_dist_alpha, dist_alpha);
    for (int s = tid; s < S; s += kConsumers) {
      const float tr = expf(pre[s]);
      trans[s] = tr;
      wts[s] = alpha[s] * tr;
#pragma unroll
      for (int c = 0; c < 3; ++c) hout[4 * s + c] = 1.f / (1.f + expf(-hout[4 * s + c]));
    }
    consumer_sync();

    // ---- composite backward (f32), nerf_bwd.cuh's backward_tail --------------
    const float* g_rgb_ray = cot;
    const float gd = cot[3];
    const float* g_w_in = g_w == nullptr ? nullptr : g_w + r * S;
    const float* g_a_in = g_a == nullptr ? nullptr : g_a + r * S;
    for (int s = tid; s < S; s += kConsumers) {
      float gw = g_rgb_ray[0] * hout[4 * s] + g_rgb_ray[1] * hout[4 * s + 1] +
                 g_rgb_ray[2] * hout[4 * s + 2] + gd * fz[s];
      if (g_w_in != nullptr) gw += g_w_in[s];
      graw[s] = gw;                       // g_w, until g_raw replaces it below
      scan1[s] = gw * wts[s];             // g_c = g_trans * trans
    }
    consumer_sync();
    for (int s = tid; s < S; s += kConsumers) scan0[s] = s + 1 < S ? scan1[s + 1] : 0.f;
    consumer_sync();
    float* src = scan0;
    float* dst = scan1;
    for (int d = 1; d < S; d <<= 1) {
      for (int s = tid; s < S; s += kConsumers) dst[s] = s + d < S ? src[s] + src[s + d] : src[s];
      consumer_sync();
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    for (int s = tid; s < S; s += kConsumers) {
      const float gw = graw[s], a = alpha[s], w = wts[s];
      float g_alpha = gw * trans[s] - src[s] / (1.f - a + kEps);
      if (g_a_in != nullptr) g_alpha += g_a_in[s];
      const float raw = hout[4 * s + 3];
      const float sigma = density_act(raw, occ_softplus);
      const float occ = head_dist_alpha ? sigma : 1.f - expf(-sigma);
      float g_occ = g_alpha, g_delta = 0.f;
      if (dist_alpha) {
        if (s == S - 1) {
          g_occ = 0.f;
        } else {
          const float delta = fz[s + 1] - fz[s];
          const float E = expf(-occ * delta);
          g_occ = g_alpha * delta * E;
          g_delta = g_alpha * occ * E;
        }
      }
      dst[s] = g_delta;
      const float g_sigma = head_dist_alpha ? g_occ : g_occ * (1.f - occ);
      const float g_raw =
          occ_softplus ? g_sigma * (1.f / (1.f + expf(-raw))) : (raw > 0.f ? g_sigma : 0.f);
      graw[s] = g_raw;
      gz[s] = gd * w;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rgb = hout[4 * s + c];
        grgb[4 * s + c] = w * g_rgb_ray[c] * rgb * (1.f - rgb);
      }
    }
    consumer_sync();
    if (dist_alpha) {
      for (int s = tid; s < S; s += kConsumers) gz[s] = gz[s] - dst[s] + (s > 0 ? dst[s - 1] : 0.f);
    }
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

      float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // d_o xyz, d_v xyz
      float dzr[2] = {0.f, 0.f};
      const int m0 = 16 * warp;
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int m = m0 + gq + 8 * hrow;
        const float zz = fz[p0 + m];
        float pts[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) pts[c] = __fadd_rn(ray[c], __fmul_rn(ray[3 + c], zz));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {
            int c;
            const float tv = enc_lane_grad90(dpe[4 * j + 2 * hrow + hc], pts, 8 * j + 2 * t + hc,
                                             10, &c);
            if (c >= 0) {
              dzr[hrow] += tv * ray[3 + c];
#pragma unroll
              for (int cc = 0; cc < 3; ++cc) {
                if (c == cc) {
                  sums[cc] += tv;
                  sums[3 + cc] += tv * zz;
                }
              }
            }
          }
        }
        dzr[hrow] += __shfl_xor_sync(0xffffffffu, dzr[hrow], 1);
        dzr[hrow] += __shfl_xor_sync(0xffffffffu, dzr[hrow], 2);
        if (t == 0) gz[p0 + m] += dzr[hrow];
      }
      block_sum90<6>(sums, red);
      if (tid < 6) rsum[tid] += red[tid];
      consumer_sync();
    }

    // ---- direction encoding, once per ray: dde = (sum_s bf16 g_h) wrde^T -----
    stage_w12<D>(w12, tiles + T::kW12);
    consumer_sync();
    if (tid < kDe) {
      float dd = 0.f;
#pragma unroll 16
      for (int j = 0; j < H; ++j) {
        const bf16 wv = *reinterpret_cast<const bf16*>(w12 + swz(j, tid, 0));
        dd = fmaf(ghsum[j], __bfloat162float(wv), dd);
      }
      int c;
      red[tid] = enc_lane_grad(dd, ray + 6, tid, 4, &c);
      red[kDe + tid] = static_cast<float>(c);
    }
    consumer_sync();
    if (tid < 3) {
      float acc = 0.f;
      for (int k = 0; k < kDe; ++k)
        if (static_cast<int>(red[kDe + k]) == tid) acc += red[k];
      rsum[6 + tid] = acc;
    }
    consumer_sync();
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
// aligned); biases: 12 f32 device pointers in the Net layout. scratch:
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
