// Point-query NeRF MLP backward for a frozen network on Hopper (sm_90a):
// K6's frozen-network variant, d(points) and d(directions) only, on the
// wgmma dX chain of mlp_dx_sm90.cuh.
//
// Replaces, for a network that takes no gradient, the TPU kernel
// nope_nerf_tpu/ops/pallas_mlp.py::_bwd_kernel (reached through
// _raw_backward, the custom VJP of nerf_apply_fused) with the head VJP and
// the encoding VJP the JAX package runs around it (pallas_mlp.py:421-442).
// Test-time pose optimisation with hierarchical sampling queries the frozen
// network twice per step and needs the points' gradient only (it carries the
// pose's); the JAX package's VJP forms the dW/dB as well and drops them.
// What it computes is point_mlp_bwd.cu's d(points) and d(directions), bit
// for bit: per 128-point pass, the forward (K5's function), the head VJP in
// f32, the MLP's dX chain with the TPU kernel's rounding, the direction
// encoding's cotangent g_h W12 and the position encoding's g0 W0 + g4 W5pe,
// each pulled through its encoding to the coordinates with the forward's own
// f32 sin/cos. Inputs: points and directions (M, 3), the cotangents of rgb
// (M, 3) and density (M, 1), f32. Outputs: d(points), d(directions) (M, 3).
//
// Bound: compute. Forward + dX, 2.37 MFLOP a point at D=256 (the direction
// product per point), against 64 bytes of input and output a point and the
// weights once. No activation goes to device memory (mlp_dx_sm90.cuh).
//
// Design: the chain over 128 consecutive points, as point_mlp_fwd.cu walks
// them: persistent CTAs, one per SM, over the passes blockIdx.x, blockIdx.x +
// gridDim.x, ...; the producer warpgroup streams each pass's forward slices
// and then its backward slices, and encodes the next pass's points and
// directions while the consumers run the current one. A ragged last pass has
// zero points, directions and cotangents in rows n..127, whose outputs are
// not written.
//
// Shared memory at D=256: activations 64 KB, position and direction
// encodings 16 KB each, heads 6 KB, masks 34 KB, f32 arrays 5 KB, two 32 KB
// ring stages.

#include "mlp_dx_sm90.cuh"

namespace {

// f32 arrays: raw heads (128, 4), raw-rgb cotangents (128, 4), raw-density
// cotangents and their bf16 values (128 each).
constexpr size_t kFrozenF32Bytes = sizeof(float) * kPts * (4 + 4 + 1 + 1);

template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
point_mlp_bwd_frozen_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                            const float* __restrict__ g_rgb, const float* __restrict__ g_density,
                            const unsigned char* __restrict__ tiles,
                            const unsigned char* __restrict__ tiles_dx, Biases bias,
                            unsigned char* scratch, float* __restrict__ dpts,
                            float* __restrict__ ddirs, long long M, int occ_softplus,
                            int head_dist_alpha, Layout90<D> L) {
  using T = Tiles<D>;
  constexpr int H = D / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = setup90(smem_raw, L.bars, L.stages);
  Ring ring = make_ring(base, L.ring, L.bars, T::kFull, L.stages);
  const uint32_t head_bar = ring.full + 16 * kMaxStages;
  const uint32_t heads = smem_addr(base + L.heads);
  const Handoff hand = make_handoff(ring);
  const long long n_pass = (M + kPts - 1) / kPts;

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    const int etid = threadIdx.x - kConsumers - 32;
    if (threadIdx.x == kConsumers) {
      const long long mine = (n_pass - blockIdx.x + gridDim.x - 1) / gridDim.x;
      mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
      bulk_load(heads, tiles + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
      Feeder f{ring};
      for (long long k = 0; k < mine; ++k) {
        f.forward<D>(tiles, T::kPoint);
        f.backward<D, true>(tiles_dx);
      }
    } else if (etid >= 0) {
      // encoders: point_mlp_fwd.cu's, the CTA's passes in order
      unsigned char* pe = base + L.pe;
      unsigned char* de = base + L.de;
      long long tile = 0;
      for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
        const long long p0 = pass * kPts;
        const int n = static_cast<int>(M - p0 < kPts ? M - p0 : kPts);
        wait_free(hand.pe_free, tile);
        encode_tile<10, kPe>(pe, etid, [&](int p, int c) {
          return p < n ? pts[3 * (p0 + p) + c] : 0.f;
        });
        hand_over(hand.pe_full);
        wait_free(hand.de_free, tile);
        encode_tile<4, kDe>(de, etid, [&](int p, int c) {
          return p < n ? dirs[3 * (p0 + p) + c] : 0.f;
        });
        hand_over(hand.de_full);
      }
    }
    return;
  }
  set_consumer_regs();

  float* hout = reinterpret_cast<float*>(base + L.f32 + mask_bytes<D>());   // (128, 4) raw
  float* grgb = hout + 4 * kPts;                          // raw-rgb cotangent     (128, 4)
  float* graw = grgb + 4 * kPts;                          // raw-density cotangent (128)
  float* gsbf = graw + kPts;                              // its bf16 value        (128)
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + L.f32);
  const uint32_t* mask_h = masks + 8 * mask_layer_words<D>();
  unsigned char* save = scratch + static_cast<size_t>(blockIdx.x) * kPts * D * 2;
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  const uint32_t pe_s = smem_addr(base + L.pe), de_s = smem_addr(base + L.de);
  const uint32_t act_s = smem_addr(base + L.act) + (threadIdx.x >> 7) * kWgRowBytes;
  const int tid = threadIdx.x;
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
    const long long p0 = pass * kPts;
    const int n = static_cast<int>(M - p0 < kPts ? M - p0 : kPts);
    mlp_tile_masks<D>(bias.b, pe_s, de_s, base + L.act, heads, heads + T::kDensHead, bias.b[10],
                      hout, hand, tile, ring, masks);
    consumer_sync();   // both warpgroups' raw heads are in

    // ---- head VJP (f32); rows of a ragged pass get zero cotangents -------------
    if (tid < kPts) {
      const bool live = tid < n;
      const float raw = hout[4 * tid + 3];
      const float gd = live ? g_density[p0 + tid] : 0.f;
      const float sigma = density_act(raw, occ_softplus);
      const float g_sigma = head_dist_alpha ? gd : gd * expf(-sigma);
      const float gr =
          occ_softplus ? g_sigma * (1.f / (1.f + expf(-raw))) : (raw > 0.f ? g_sigma : 0.f);
      graw[tid] = gr;
      gsbf[tid] = bf16_round(gr);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float s = 1.f / (1.f + expf(-hout[4 * tid + k]));
        grgb[4 * tid + k] = (live ? g_rgb[3 * (p0 + tid) + k] : 0.f) * (s * (1.f - s));
      }
    }
    rgb_head_bwd<D>(base + L.act, grgb, mask_h, rgb_head, nullptr, nullptr);

    {  // d(directions) = (g_h wrde^T) through the direction encoding, per point
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      ring_products<32>(acc, act_s, H / 64, 4, ring);
      coord_grad90<4>(acc, dirs, 4, n, p0, ddirs);
    }
    float dpe[32];
    dx_chain<D>(dpe, base + L.act, ring, masks, gsbf, dens_head, save);
    coord_grad90<8>(dpe, pts, 10, n, p0, dpts);
  }
}

template <int D>
cudaError_t launch_frozen(const float* pts, const float* dirs, const float* g_rgb,
                          const float* g_density, const unsigned char* tiles,
                          const unsigned char* tiles_dx, const Biases& bias,
                          unsigned char* scratch, float* dpts, float* ddirs, long long M,
                          int n_ctas, int occ_softplus, int head_dist_alpha,
                          cudaStream_t stream) {
  const size_t area = mask_bytes<D>() + kFrozenF32Bytes;   // masks, then the f32 arrays
  const Layout90<D> L(true, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  cudaError_t err = cudaFuncSetAttribute(point_mlp_bwd_frozen_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  point_mlp_bwd_frozen_kernel<D><<<n_ctas, kThreads90, smem, stream>>>(
      pts, dirs, g_rgb, g_density, tiles, tiles_dx, bias, scratch, dpts, ddirs, M, occ_softplus,
      head_dist_alpha, L);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_mlp.py.
// pts, dirs, g_rgb (M, 3) and g_density (M, 1) f32, contiguous on the device;
// tiles: pack_tiles' forward weight buffer, tiles_dx: pack_tiles_dx's
// backward buffer (both 16-byte aligned); biases: 12 f32 device pointers in
// pack_weights' order. scratch: n_ctas x 128 x D bf16 (the chain's parked g4).
// dpts, ddirs (M, 3) f32 (out). 0 < n_ctas <= the number of 128-point
// passes. Returns a cudaError_t (0 on success); the launch is asynchronous
// on `stream`.
extern "C" int nerf_point_mlp_bwd_frozen(const float* pts, const float* dirs, const float* g_rgb,
                                         const float* g_density, const void* tiles,
                                         const void* tiles_dx, const void* const* biases,
                                         void* scratch, float* dpts, float* ddirs, long long M,
                                         int D, int n_ctas, int occ_softplus, int head_dist_alpha,
                                         void* stream) {
  const long long n_pass = (M + kPts - 1) / kPts;
  if (M <= 0 || n_ctas <= 0 || n_ctas > n_pass) return static_cast<int>(cudaErrorInvalidValue);
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
      err = launch_frozen<256>(pts, dirs, g_rgb, g_density, w, wdx, bias, sc, dpts, ddirs, M,
                               n_ctas, occ_softplus, head_dist_alpha, st);
      break;
    case 128:
      err = launch_frozen<128>(pts, dirs, g_rgb, g_density, w, wdx, bias, sc, dpts, ddirs, M,
                               n_ctas, occ_softplus, head_dist_alpha, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
