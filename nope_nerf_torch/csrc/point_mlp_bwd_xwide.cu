// Point-query NeRF MLP backward on Hopper (sm_90a) at hidden_dim 640, 768,
// 896 and 1024: K6, the VJP of point_mlp_fwd.cu's function with every weight
// and bias gradient (point_mlp_bwd.cu's function, numerics and three
// launches at 128 to 512), on the dX chain of mlp_dx_xwide_sm90.cuh and the
// weight-gradient kernel of dw_sm90.cuh.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_mlp.py::_bwd_kernel at
// these widths, with the head VJP and the encoding VJP the JAX package runs
// around it (pallas_mlp.py:421-442). Inputs: the points and directions (M,
// 3), the cotangents of rgb (M, 3) and density (M, 1), f32. Outputs: dW (14
// blocks) and dB (12) in nerf_bwd.cuh's grad_layout, d(points), d(directions)
// (M, 3).
//
// A translation unit of its own, with point_mlp_bwd.cu's C entries
// (ops/fused_mlp.py binds this library past 512): built beside the 384 and
// 512 kernels, these instances moved those kernels' SASS (their stack
// frame's layout; outputs bit-equal), which invariant (I4) below keeps.
//
// Bound: compute, forward + dX + dW, three products a layer (chip_smoke.py's
// mlp_flops x 3): 4.214 TFLOP at 640 and 10.686 at 1024 over 196,608 points,
// 4.261 and 10.804 ms at 989 TFLOP/s. The X and G operands handed to the dW
// kernel stay out of the bound.
//
// Design: point_mlp_bwd_xwide_kernel runs point_mlp_bwd.cu's three launches
// on mlp_dx_xwide_sm90.cuh's chain (point_mlp_bwd_frozen.cu's xwide kernel:
// K5's forward with its masks, mlp_tile_x_masks<D, true>, then the dX chain
// in passes of 128 columns, each product summed slice by slice from zero)
// with mlp_dw_chain_sm90.cuh's OperandSaveX as its hook: in pass p of a layer
// warpgroup g writes 64-column block 2p + g, and saves the blocks it wrote
// once the layer is whole in the buffer; the dX epilogues' column sums keep
// each pass apart (red_pass) and go to the warpgroup's segment at each
// column's place; the rgb head's blocks stay in the chain
// (rgb_head_bwd_x_full), dW[9] as at 384 and 512 (density_head_dw_w). The
// dW kernel's table there is 34 pieces at 640 and 768, 46 at 896, 44 at
// 1024: more than one launch takes (kDwMaxBlocks, 24), so chain_dw_launch
// issues it as two launches in table order with one `chunks` for both; a
// piece's sum depends only on the chunk split, so no bit depends on where
// the table is cut. The dW kernel's code is unchanged.
//
// Invariants past 512, fixed before the kernel's first run on a card
// (chip_smoke.py phase 16 holds them):
// (I1) d(points) and d(directions) are K6 frozen's, torch.equal, at every
//      width and point count of WIDE_FULL_M and both flag sets: the same
//      chain, the same products in the same order, the same g4 parked and
//      taken back; the hook only adds stores and sums.
// (I2) The X operands handed to the dW kernel are torch.equal to those K5's
//      check build (point_mlp_fwd.cu with FwdOperandSave, OperandSaveW's
//      split of the copies) writes from the same inputs.
// (I3) Two launches are bit-equal in every output: no float atomics.
// (I4) At 128 to 512 every instance of K6 full, K6 frozen, K4 frozen and the
//      dW kernel keeps its SASS and outputs, and so does every instance of
//      K4 frozen and K6 frozen at 640 to 1024 (the chain's hook defaults to
//      NoSaveW; tools/forward_timing.py --sass, parent and change).
// (N1) tools/backward_noise.py --full --widths 640 1024: the mean L2
//      distance of the dW and dB blocks from the f64 sum, over 6 seeds a
//      flag set at 196,645 points, at most 2.0 x the f32 plain version's on
//      every width and flag set, or the kernel is at fault.
//
// Where trouble was expected past 512, and what the build found (PERF.md
// section 6; on an NVIDIA H100 80GB HBM3 at 700 W):
// - The dW kernel's geometry: 138 CTA tiles at 640, 164 at 768, 256 at
//   896, 282 at 1024, so dw_chunks gives 1 chunk at every width, each CTA
//   summing over every row tile (1,537 at 196,608 points). Found: on the
//   wgmma accumulator, which truncates, that put the dW and dB blocks 4.45
//   to 6.0 x the f32 plain version's mean L2 distance from the f64 sum,
//   against (N1)'s 2.0. The wrapper now splits the points into chunks of at
//   most 64 row tiles here (ops/fused_mlp.py::point_dw_chunks: 24 at 196,608
//   points), summed in f32 in chunk order: 0.93 to 0.98 x. The dW kernel is
//   17 to 18% of the call.
// - Operand memory: X and G come to 23,936 B a point at 640 and 38,144 B at
//   1024 (19,200 at 512): 4.71 and 7.50 GB at 196,608 points. No budget
//   caps them.
// - Scratch a CTA: g4 (64 x D bf16), the staging (64 x (D - 128) bf16), one
//   tile's masks and the column sums (8 D floats): 214,016 B at 640,
//   352,256 B at 1024 (46.5 MB over 132 CTAs, about L2's size).
// - store_dx_w's SUM at N = 64: pass p's four warp sums at red_pass(i, wg,
//   p) = red_at(i, wg) + 256 p, D/128 passes in red_at's 2 D floats, so the
//   other warpgroup's region is never touched.
// - Spills (ptxas, stores / loads): 152 / 424 B at 640, 232 / 756 at 768,
//   160 / 488 at 896, 256 / 828 at 1024.
// - One point: a block summed over one point moves by several times 2e-2 of
//   its norm with one flipped ReLU mask, in the kernel or in the f32 plain
//   version (cuBLAS) alike; chip_smoke.check_wide_full holds the kernel to
//   the f64 sum where the f32 plain version strays beyond the rule.

#include <type_traits>

#include "mlp_dw_chain_sm90.cuh"

namespace {

// f32 arrays: raw heads (64, 4), raw-rgb cotangents (64, 4), raw-density
// cotangents and their bf16 values (64 each).
constexpr size_t kXwideF32Bytes = sizeof(float) * kWRows * (4 + 4 + 1 + 1);

// A CTA's scratch past 512: the parked g4, the staging of a layer's passes,
// one tile's ReLU masks, the column sums.
template <int D>
__host__ __device__ constexpr size_t xwide_scratch() {
  return g4_bytes_w<D>() + TilesX<D>::kStageBytes + mask_tile_bytes_x<D>() + red_bytes_w<D>();
}

// K6 full at D = 640 to 1024: point_mlp_bwd_frozen.cu's xwide kernel (the
// same producer, forward, head VJP, direction product and chain, the same
// d(points) and d(directions) bits) with OperandSaveX as the hook of the
// forward and the chain, the rgb head's backward with its gradients
// (rgb_head_bwd_x_full) and dW[9] from x7's operand tile (density_head_dw_w).
template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
point_mlp_bwd_xwide_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                           const float* __restrict__ g_rgb, const float* __restrict__ g_density,
                           const unsigned char* __restrict__ tiles,
                           const unsigned char* __restrict__ tiles_dx, Biases bias,
                           unsigned char* xops, unsigned char* gops, float* chain_part,
                           unsigned char* scratch, float* __restrict__ dpts,
                           float* __restrict__ ddirs, long long M, int occ_softplus,
                           int head_dist_alpha, LayoutX<D> L) {
  using T = TilesX<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = setup90(smem_raw, L.bars, L.stages);
  Ring ring = make_ring(base, L.ring, L.bars, T::kFull, L.stages);
  const uint32_t head_bar = ring.full + 16 * kMaxStages;
  const uint32_t heads = smem_addr(base + L.heads);
  const Handoff hand = make_handoff(ring);
  const long long n_pass = (M + kWRows - 1) / kWRows;

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    const int etid = threadIdx.x - kConsumers - 32;
    if (threadIdx.x == kConsumers) {
      const long long mine = (n_pass - blockIdx.x + gridDim.x - 1) / gridDim.x;
      mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
      bulk_load(heads, tiles + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
      Feeder f{ring};
      for (long long k = 0; k < mine; ++k) {
        push_forward_x<D>(f, tiles, true);
        push_backward_x<D, true>(f, tiles_dx);
      }
    } else if (etid >= 0) {
      unsigned char* pe = base + L.pe;
      unsigned char* de = base + L.de;
      long long tile = 0;
      for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
        const long long p0 = pass * kWRows;
        const int n = static_cast<int>(M - p0 < kWRows ? M - p0 : kWRows);
        wait_free(hand.pe_free, tile);
        encode_tile<10, kPe, kWRows>(pe, etid, [&](int p, int c) {
          return p < n ? pts[3 * (p0 + p) + c] : 0.f;
        });
        hand_over(hand.pe_full);
        wait_free(hand.de_free, tile);
        encode_tile<4, kDe, kWRows>(de, etid, [&](int p, int c) {
          return p < n ? dirs[3 * (p0 + p) + c] : 0.f;
        });
        hand_over(hand.de_full);
      }
    }
    return;
  }
  set_consumer_regs();

  const GradLayout lay = grad_layout(D);
  const int seg = chain_seg(D, lay.w[13], lay.sums);
  float* hout = reinterpret_cast<float*>(base + L.f32);   // (64, 4) raw
  float* grgb = hout + 4 * kWRows;                        // raw-rgb cotangent     (64, 4)
  float* graw = grgb + 4 * kWRows;                        // raw-density cotangent (64)
  float* gsbf = graw + kWRows;                            // its bf16 value        (64)
  unsigned char* g4 = scratch + static_cast<size_t>(blockIdx.x) * xwide_scratch<D>();
  unsigned char* stage = g4 + g4_bytes_w<D>();
  uint32_t* masks = reinterpret_cast<uint32_t*>(stage + T::kStageBytes);
  float* red = reinterpret_cast<float*>(stage + T::kStageBytes + mask_tile_bytes_x<D>());
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  const uint32_t pe_s = smem_addr(base + L.pe), de_s = smem_addr(base + L.de);
  const uint32_t act_s = smem_addr(base + L.act);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  float* part0 = chain_part + static_cast<size_t>(blockIdx.x) * 2 * seg;   // CTA-wide sums
  for (int e = tid; e < 2 * seg; e += kConsumers) part0[e] = 0.f;
  __threadfence_block();
  OperandSaveX<D> hook;
  hook.tiles = PassTilesW<D>{xops, gops, static_cast<size_t>((M + kPts - 1) / kPts) * kBlockBytes,
                             0};
  hook.red = red;
  hook.part = part0;
  hook.seg = seg;
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
    const long long p0 = pass * kWRows;
    const int n = static_cast<int>(M - p0 < kWRows ? M - p0 : kWRows);
    hook.tiles.pass = pass;
    mlp_tile_x_masks<D>(bias.b, pe_s, de_s, base + L.act, heads, heads + T::kDensHead,
                        bias.b[10], hout, hand, tile, ring, masks, stage, hook);
    __threadfence_block();   // x7's operand tile, before other threads read it back
    consumer_sync();         // both warpgroups' raw heads are in

    // ---- head VJP (f32); rows of a ragged pass get zero cotangents -------------
    if (tid < kWRows) {
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
    rgb_head_bwd_x_full<D>(base + L.act, grgb, graw, masks + 8 * mask_layer_words_x<D>(),
                           rgb_head, red, part0, part0 + wg * seg);
    density_head_dw_w<D>(hook.tiles, gsbf, part0);

    // d(directions) = (g_h wrde^T) through the direction encoding, by warpgroup 0
    if (wg == 0) {
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      ring_products_x<32, 2>(acc, act_s, T::kPasses, 0, ring);
      coord_grad90<4>(acc, dirs, 4, n, p0, ddirs);
    } else {
      ring_skip(T::kPasses, ring);
    }
    float dpe[32];
    dx_chain_x<D>(dpe, base + L.act, stage, ring, masks, gsbf, dens_head, g4, hook);
    if (wg == 0) coord_grad90<8>(dpe, pts, 10, n, p0, dpts);
    consumer_sync();   // the pass is done with every buffer before the next one's forward
  }
  bulk_complete();   // every bulk copy of the CTA's operands, before it exits
}

template <int D>
cudaError_t launch_bwd_x(const float* pts, const float* dirs, const float* g_rgb,
                         const float* g_density, const unsigned char* tiles,
                         const unsigned char* tiles_dx, const Biases& bias, unsigned char* xops,
                         unsigned char* gops, float* chain_part, unsigned char* scratch,
                         float* dw_part, float* grads, float* dpts, float* ddirs, long long M,
                         int n_ctas, int chunks, int occ_softplus, int head_dist_alpha,
                         int* launches, cudaStream_t stream) {
  const LayoutX<D> L(true, kXwideF32Bytes);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(kXwideF32Bytes);
  cudaError_t err = cudaFuncSetAttribute(point_mlp_bwd_xwide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  point_mlp_bwd_xwide_kernel<D><<<n_ctas, kThreads90, smem, stream>>>(
      pts, dirs, g_rgb, g_density, tiles, tiles_dx, bias, xops, gops, chain_part, scratch, dpts,
      ddirs, M, occ_softplus, head_dist_alpha, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launches[0] = 1;
  const GradLayout lay = grad_layout(D);
  err = chain_reduce_launch(chain_part, grads, chain_seg(D, lay.w[13], lay.sums), n_ctas, D,
                            lay.w[13], stream);
  if (err != cudaSuccess) return err;
  return chain_dw_launch<D>(xops, gops, grads, (M + kPts - 1) / kPts, true, M, chunks, dw_part,
                            stream, false, launches + 1);
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_mlp.py: point_mlp_bwd.cu's
// entries at D = 640, 768, 896 and 1024.

// Offsets (floats) of the 14 dW blocks and the 12 dB blocks in the gradient
// buffer, into offsets[26]; returns the buffer's length, or 0 for a width the
// kernel is not built for.
extern "C" int nerf_point_mlp_grad_layout(int D, int* offsets) {
  if (D != 640 && D != 768 && D != 896 && D != 1024) return 0;
  const GradLayout lay = grad_layout(D);
  for (int i = 0; i < 14; ++i) offsets[i] = lay.w[i];
  for (int i = 0; i < 12; ++i) offsets[14 + i] = lay.b[i];
  return lay.total;
}

// Bytes of nerf_point_mlp_bwd's scratch buffers into sizes[0..3]: the X and
// G operands, the chain's partial sums, the dW kernel's partials per chunk of
// points; the dW kernel's CTA tiles over both launches of its table into
// sizes[4], from which the caller picks the chunks; the CTAs' scratch (g4,
// the staging, a tile's masks, the column sums) into sizes[5]. Returns 0, or
// cudaErrorInvalidValue for a width the kernel is not built for.
extern "C" int nerf_point_mlp_bwd_scratch(int D, long long M, int n_ctas, long long* sizes) {
  const long long n_pass = (M + kPts - 1) / kPts;   // the operands' 128-row tiles
  auto sized = [&](auto width) {
    constexpr int W = decltype(width)::value;
    const GradLayout lay = grad_layout(W);
    chain_scratch_sizes<W>(n_pass, n_ctas, chain_seg(W, lay.w[13], lay.sums), true, sizes);
    sizes[5] = static_cast<long long>(xwide_scratch<W>()) * n_ctas;
    return 0;
  };
  switch (D) {
    case 640:
      return sized(std::integral_constant<int, 640>());
    case 768:
      return sized(std::integral_constant<int, 768>());
    case 896:
      return sized(std::integral_constant<int, 896>());
    case 1024:
      return sized(std::integral_constant<int, 1024>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// point_mlp_bwd.cu's nerf_point_mlp_bwd at D = 640 to 1024: the same
// arguments; scratch (sizes[5] bytes) is required; 0 < n_ctas <= the number
// of 64-point passes, 0 < chunks <= the number of 128-point row tiles.
// Returns a cudaError_t (0 on success); the launches are asynchronous on
// `stream`.
extern "C" int nerf_point_mlp_bwd(const float* pts, const float* dirs, const float* g_rgb,
                                  const float* g_density, const void* tiles, const void* tiles_dx,
                                  const void* const* biases, void* xops, void* gops,
                                  float* chain_part, float* dw_part, void* scratch, float* grads,
                                  float* dpts, float* ddirs, long long M, int D, int n_ctas,
                                  int chunks, int occ_softplus, int head_dist_alpha, int total,
                                  int* launches, void* stream) {
  const long long n_pass = (M + kWRows - 1) / kWRows;
  const long long row_tiles = (M + kPts - 1) / kPts;
  if (M <= 0 || n_ctas <= 0 || n_ctas > n_pass || chunks <= 0 || chunks > row_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((D != 640 && D != 768 && D != 896 && D != 1024) || total != grad_layout(D).total ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(tiles_dx) |
       reinterpret_cast<uintptr_t>(xops) | reinterpret_cast<uintptr_t>(gops) |
       reinterpret_cast<uintptr_t>(scratch)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Biases bias;
  for (int i = 0; i < 12; ++i) bias.b[i] = static_cast<const float*>(biases[i]);
  const auto* w = static_cast<const unsigned char*>(tiles);
  const auto* wdx = static_cast<const unsigned char*>(tiles_dx);
  auto* xo = static_cast<unsigned char*>(xops);
  auto* go = static_cast<unsigned char*>(gops);
  auto* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto width) {
    return launch_bwd_x<decltype(width)::value>(pts, dirs, g_rgb, g_density, w, wdx, bias, xo,
                                                go, chain_part, sc, dw_part, grads, dpts, ddirs,
                                                M, n_ctas, chunks, occ_softplus, head_dist_alpha,
                                                launches, st);
  };
  launches[0] = launches[1] = 0;
  cudaError_t err;
  switch (D) {
    case 640:
      err = run(std::integral_constant<int, 640>());
      break;
    case 768:
      err = run(std::integral_constant<int, 768>());
      break;
    case 896:
      err = run(std::integral_constant<int, 896>());
      break;
    default:
      err = run(std::integral_constant<int, 1024>());
  }
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
