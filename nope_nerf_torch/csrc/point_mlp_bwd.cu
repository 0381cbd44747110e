// Point-query NeRF MLP backward on Hopper (sm_90a): K6, the VJP of
// point_mlp_fwd.cu's function with every weight and bias gradient, the
// forward recomputed per pass, on the wgmma dX chain of mlp_dx_sm90.cuh and
// the weight-gradient kernel of dw_sm90.cuh.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_mlp.py::_bwd_kernel
// (reached through _raw_backward, the custom VJP of nerf_apply_fused)
// together with the head VJP and the encoding VJP that the JAX package runs
// around it in XLA (pallas_mlp.py:421-442). Inputs: the points and directions
// (M, 3) and the cotangents of the outputs, g_rgb (M, 3) and g_density (M, 1),
// f32. Outputs: dW (14 blocks, stored (in, out)) and dB (12) in the layout of
// nerf_bwd.cuh's grad_layout, d(points) (M, 3), d(directions) (M, 3).
//
// Numerics, the TPU kernel's (pallas_mlp.py:197-261): every cotangent rounded
// to bf16 before it enters a product (dX = g W^T, dW = x^T g), each dW formed
// from bf16 operands with f32 sums (`_dmat`), ReLU masks from the bf16
// activations, each dB summed from the masked f32 cotangents before their
// rounding; the encodings' cotangents pulled to the points and directions
// with the forward's own f32 sin/cos. d(points) and d(directions) are
// point_mlp_bwd_frozen.cu's, bit for bit: the same chain.
//
// Bound: compute. Forward + dX + dW are three products per layer, 3.56 MFLOP
// a point at D = 256, against 64 bytes of input and output a point and the
// weights and their gradients once. The operands the chain hands to the dW
// kernel (4.8 KB of X and 4.9 KB of G a point at D = 256, written once and
// read once) are the kernel's own choice and stay out of the bound.
//
// Design, three launches on one stream (the hand-off is
// mlp_dw_chain_sm90.cuh's, shared with the render kernels):
// 1. The chain, point_mlp_bwd_frozen.cu's kernel (persistent CTAs over
//    128-point passes; two consumer warpgroups on the wgmma trunk and dX
//    chain; a producer warpgroup streaming the weight slices and encoding
//    the next pass), which besides d(points) and d(directions) writes every
//    operand of a dW product to device memory, copied by each warpgroup from
//    its rows of shared memory once they are final: X = pe, x0..x7, feat, de
//    (the forward's activation buffer and encoding blocks) and G = g_h,
//    g_feat, g7..g0 (the bf16 cotangents the dX epilogues write over the
//    activations), in dw_sm90.cuh's tiled layout, one row tile per pass. The
//    dX epilogues also form the f32 column sums of the masked cotangents
//    (store_dx's SUM), summed per warpgroup in warp order into per-CTA bias
//    partials. The heads' rank-1 and rank-3 blocks stay here as scalar f32
//    sums: dW[9] = x7^T bf16(g_sigma) (x7 read back from its operand tile),
//    dW[13] = h^T bf16(g_rgb) (h read before g_h overwrites it), dB[8],
//    dB[10], dB[11]. g4 goes to dpe (after g0 W0) from its operand tile.
// 2. The chain's partials summed in CTA order (and warpgroup order) into the
//    gradient buffer.
// 3. dw_sm90.cuh on K6's work table (chain_dw_pieces): the 12 other dW blocks.
// No float atomics anywhere: two launches give the same bits.
//
// Shared memory at D=256: point_mlp_bwd_frozen.cu's (activations 64 KB,
// encodings 32 KB, heads 6 KB, masks 34 KB, f32 arrays 5 KB, two 32 KB ring
// stages) and 8 KB of per-warp bias sums.
//
// At D = 384 and 512, point_mlp_bwd_wide_kernel runs the same three launches
// on the 64-point chain of mlp_dx_wide_sm90.cuh (point_mlp_bwd_frozen.cu's
// wide kernel, the same d(points) and d(directions) bits) with
// mlp_dw_chain_sm90.cuh's OperandSaveW as its hook: pass t writes half t % 2
// of each operand's row tile t / 2, each dX epilogue writes its warps' bias
// column sums to the CTA's scratch, which the warpgroup then adds in warp
// order to its segment, and the rgb head's and the density head's blocks stay
// in the chain (rgb_head_bwd_w_full, density_head_dw_w). Shared memory is the
// frozen variant's (222.5 KB of 227 at 512); the ReLU masks, the parked g4 and
// the column sums go to a per-CTA scratch in device memory (114 KB at 512).
// The dW kernel takes blocks wider than 256 columns as column pieces (24 at
// 384, 22 at 512).
//
// At D = 640 to 1024 K6 full is point_mlp_bwd_xwide.cu, a translation unit
// of its own with the same C entries: built beside the kernels here, its
// instances moved the SASS of the 384 and 512 ones (their outputs bit-equal;
// the stack frame's layout moved), and those keep their code.

#include "mlp_dw_chain_sm90.cuh"

namespace {

// f32 arrays: raw heads (128, 4), raw-rgb cotangents (128, 4), raw-density
// cotangents and their bf16 values (128 each), then the per-warp bias sums
// (2 warpgroups x 4 warps x D; the rgb head's 4 x 256 sums use them too).
template <int D>
constexpr size_t full_f32_bytes() {
  return sizeof(float) * (kPts * (4 + 4 + 1 + 1) + 8 * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
point_mlp_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                     const float* __restrict__ g_rgb, const float* __restrict__ g_density,
                     const unsigned char* __restrict__ tiles,
                     const unsigned char* __restrict__ tiles_dx, Biases bias,
                     unsigned char* xops, unsigned char* gops, float* chain_part,
                     float* __restrict__ dpts, float* __restrict__ ddirs, long long M,
                     int occ_softplus, int head_dist_alpha, Layout90<D> L) {
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

  const GradLayout lay = grad_layout(D);
  const int seg = chain_seg(D, lay.w[13], lay.sums);
  float* hout = reinterpret_cast<float*>(base + L.f32 + mask_bytes<D>());   // (128, 4) raw
  float* grgb = hout + 4 * kPts;                          // raw-rgb cotangent     (128, 4)
  float* graw = grgb + 4 * kPts;                          // raw-density cotangent (128)
  float* gsbf = graw + kPts;                              // its bf16 value        (128)
  float* red = gsbf + kPts;                               // per-warp sums         (8, D)
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + L.f32);
  const uint32_t* mask_h = masks + 8 * mask_layer_words<D>();
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  const uint32_t pe_s = smem_addr(base + L.pe), de_s = smem_addr(base + L.de);
  const uint32_t act_s = smem_addr(base + L.act) + (threadIdx.x >> 7) * kWgRowBytes;
  const int tid = threadIdx.x, wg = tid >> 7;
  float* part0 = chain_part + static_cast<size_t>(blockIdx.x) * 2 * seg;   // CTA-wide sums
  float* part_wg = part0 + wg * seg;                                         // this warpgroup's
  for (int e = tid; e < 2 * seg; e += kConsumers) part0[e] = 0.f;
  __threadfence_block();
  OperandSave<D> save;
  save.act = base + L.act;
  save.pe = base + L.pe;
  save.de = base + L.de;
  save.tiles = PassTiles<D>{xops, gops, static_cast<size_t>(n_pass) * kBlockBytes, 0};
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
    const long long p0 = pass * kPts;
    const int n = static_cast<int>(M - p0 < kPts ? M - p0 : kPts);
    save.tiles.pass = pass;
    mlp_tile_masks<D>(bias.b, pe_s, de_s, base + L.act, heads, heads + T::kDensHead, bias.b[10],
                      hout, hand, tile, ring, masks, save);
    __threadfence_block();   // the operand tiles (x7's below) before other threads read them
    consumer_sync();         // both warpgroups' raw heads are in

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
    rgb_head_bwd_full<D>(base + L.act, grgb, graw, mask_h, rgb_head, red, part0 + D,
                         part0 + D + 3 * H, lay);
    copy_rows_async(base + L.act + wg * kWgRowBytes, save.tiles.g(0) + wg * kWgRowBytes,
                    H / 64);   // g_h
    density_head_dw<D>(save.tiles, gsbf, part0);

    {  // d(directions) = (g_h wrde^T) through the direction encoding, per point
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      ring_products<32>(acc, act_s, H / 64, 4, ring);
      coord_grad90<4>(acc, dirs, 4, n, p0, ddirs);
    }
    float dpe[32];
    dx_chain_full<D>(dpe, base + L.act, ring, masks, gsbf, dens_head, save.tiles,
                     part_wg + D + 3 * H, red + wg * 4 * D, lay);
    coord_grad90<8>(dpe, pts, 10, n, p0, dpts);
  }
  bulk_complete();   // every bulk copy of the CTA's operands, before it exits
}

template <int D>
cudaError_t launch_bwd(const float* pts, const float* dirs, const float* g_rgb,
                       const float* g_density, const unsigned char* tiles,
                       const unsigned char* tiles_dx, const Biases& bias, unsigned char* xops,
                       unsigned char* gops, float* chain_part, float* dw_part, float* grads,
                       float* dpts, float* ddirs, long long M, int n_ctas, int chunks,
                       int occ_softplus, int head_dist_alpha, int* launches,
                       cudaStream_t stream) {
  const size_t area = mask_bytes<D>() + full_f32_bytes<D>();   // masks, then the f32 arrays
  const Layout90<D> L(true, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  cudaError_t err = cudaFuncSetAttribute(point_mlp_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  point_mlp_bwd_kernel<D><<<n_ctas, kThreads90, smem, stream>>>(
      pts, dirs, g_rgb, g_density, tiles, tiles_dx, bias, xops, gops, chain_part, dpts, ddirs, M,
      occ_softplus, head_dist_alpha, L);
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

// ---- hidden_dim 384 and 512: the 64-point chain of mlp_dx_wide_sm90.cuh ----------

// f32 arrays: raw heads (64, 4), raw-rgb cotangents (64, 4), raw-density
// cotangents and their bf16 values (64 each).
constexpr size_t kWideF32Bytes = sizeof(float) * kWRows * (4 + 4 + 1 + 1);

// A CTA's scratch at the wide widths: the parked g4, one tile's ReLU masks,
// the column sums.
template <int D>
__host__ __device__ constexpr size_t wide_scratch() {
  return g4_bytes_w<D>() + mask_tile_bytes_w<D>() + red_bytes_w<D>();
}

template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
point_mlp_bwd_wide_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                          const float* __restrict__ g_rgb, const float* __restrict__ g_density,
                          const unsigned char* __restrict__ tiles,
                          const unsigned char* __restrict__ tiles_dx, Biases bias,
                          unsigned char* xops, unsigned char* gops, float* chain_part,
                          unsigned char* scratch, float* __restrict__ dpts,
                          float* __restrict__ ddirs, long long M, int occ_softplus,
                          int head_dist_alpha, LayoutW<D> L) {
  using T = TilesW<D>;
  constexpr int H = D / 2;
  constexpr uint32_t kBuf = kWRows * D * 2;
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
        push_forward_w<D>(f, tiles, T::kPoint);
        push_backward_w<D, true>(f, tiles_dx);
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
  unsigned char* save = scratch + static_cast<size_t>(blockIdx.x) * wide_scratch<D>();
  uint32_t* masks = reinterpret_cast<uint32_t*>(save + g4_bytes_w<D>());
  float* red = reinterpret_cast<float*>(save + g4_bytes_w<D>() + mask_tile_bytes_w<D>());
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  const uint32_t pe_s = smem_addr(base + L.pe), de_s = smem_addr(base + L.de);
  const uint32_t act_s = smem_addr(base + L.act);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  float* part0 = chain_part + static_cast<size_t>(blockIdx.x) * 2 * seg;   // CTA-wide sums
  for (int e = tid; e < 2 * seg; e += kConsumers) part0[e] = 0.f;
  __threadfence_block();
  OperandSaveW<D> hook;
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
    mlp_tile_w_masks<D>(bias.b, pe_s, de_s, base + L.act, heads, heads + T::kDensHead,
                        bias.b[10], hout, hand, tile, ring, masks, hook);
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
    rgb_head_bwd_w_full<D>(base + L.act, grgb, graw, masks + 8 * mask_layer_words_w<D>(),
                           rgb_head, red, part0, part0 + wg * seg);
    density_head_dw_w<D>(hook.tiles, gsbf, part0);

    // d(directions) = (g_h wrde^T) through the direction encoding, by warpgroup 0
    if (wg == 0) {
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      ring_products_w<32>(acc, act_s + kBuf, H / kWSliceCols, 0, ring);
      coord_grad90<4>(acc, dirs, 4, n, p0, ddirs);
    } else {
      ring_skip(H / kWSliceCols, ring);
    }
    float dpe[32];
    dx_chain_w<D>(dpe, base + L.act, ring, masks, gsbf, dens_head, save, hook);
    if (wg == 0) coord_grad90<8>(dpe, pts, 10, n, p0, dpts);
    consumer_sync();   // the pass is done with every buffer before the next one's forward
  }
  bulk_complete();   // every bulk copy of the CTA's operands, before it exits
}

template <int D>
cudaError_t launch_bwd_w(const float* pts, const float* dirs, const float* g_rgb,
                         const float* g_density, const unsigned char* tiles,
                         const unsigned char* tiles_dx, const Biases& bias, unsigned char* xops,
                         unsigned char* gops, float* chain_part, unsigned char* scratch,
                         float* dw_part, float* grads, float* dpts, float* ddirs, long long M,
                         int n_ctas, int chunks, int occ_softplus, int head_dist_alpha,
                         int* launches, cudaStream_t stream) {
  const LayoutW<D> L(true, kWideF32Bytes);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(kWideF32Bytes);
  cudaError_t err = cudaFuncSetAttribute(point_mlp_bwd_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  point_mlp_bwd_wide_kernel<D><<<n_ctas, kThreads90, smem, stream>>>(
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

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_mlp.py.

// Offsets (floats) of the 14 dW blocks and the 12 dB blocks in the gradient
// buffer, into offsets[26]; returns the buffer's length, or 0 for a width the
// kernel is not built for. (nerf_bwd.cuh's layout; its 3 loss sums stay unused.)
extern "C" int nerf_point_mlp_grad_layout(int D, int* offsets) {
  if (D != 128 && D != 256 && D != 384 && D != 512) return 0;
  const GradLayout lay = grad_layout(D);
  for (int i = 0; i < 14; ++i) offsets[i] = lay.w[i];
  for (int i = 0; i < 12; ++i) offsets[14 + i] = lay.b[i];
  return lay.total;
}

// Bytes of nerf_point_mlp_bwd's scratch buffers into sizes[0..3]: the X and
// G operands, the chain's partial sums, the dW kernel's partials per chunk of
// points; the dW kernel's CTA tiles into sizes[4], from which the caller
// picks the chunks; and into sizes[5] the CTAs' scratch of the wide chain
// (the parked g4, a tile's ReLU masks and the bias column sums per CTA at 384
// and 512, 0 at 128 and 256). Returns 0, or cudaErrorInvalidValue for a width
// the kernel is not built for.
extern "C" int nerf_point_mlp_bwd_scratch(int D, long long M, int n_ctas, long long* sizes) {
  if (D != 128 && D != 256 && D != 384 && D != 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const GradLayout lay = grad_layout(D);
  const long long n_pass = (M + kPts - 1) / kPts;   // the operands' 128-row tiles
  const int seg = chain_seg(D, lay.w[13], lay.sums);
  sizes[5] = 0;
  switch (D) {
    case 512:
      chain_scratch_sizes<512>(n_pass, n_ctas, seg, true, sizes);
      sizes[5] = static_cast<long long>(wide_scratch<512>()) * n_ctas;
      break;
    case 384:
      chain_scratch_sizes<384>(n_pass, n_ctas, seg, true, sizes);
      sizes[5] = static_cast<long long>(wide_scratch<384>()) * n_ctas;
      break;
    case 256:
      chain_scratch_sizes<256>(n_pass, n_ctas, seg, true, sizes);
      break;
    default:
      chain_scratch_sizes<128>(n_pass, n_ctas, seg, true, sizes);
  }
  return 0;
}

// pts, dirs, g_rgb (M, 3) and g_density (M, 1) f32, contiguous on the device;
// tiles: pack_tiles' forward weight buffer, tiles_dx: pack_tiles_dx's
// backward buffer (both 16-byte aligned); biases: 12 f32 device pointers in
// pack_weights' order. xops, gops, chain_part, dw_part: scratch of the sizes
// nerf_point_mlp_bwd_scratch gives (dw_part: chunks times its size; scratch:
// sizes[5], null at 128 and 256; all 16-byte aligned). grads: total f32
// (out), dpts, ddirs (M, 3) f32 (out). 0 < n_ctas <= the number of passes
// (128 points at D = 128 and 256, 64 at 384 and 512), 0 < chunks <= the
// number of 128-point row tiles. launches: 2 ints (out), the launches made of
// the chain kernel and of the dW kernel. Returns a cudaError_t (0 on success); the
// launches are asynchronous on `stream`.
extern "C" int nerf_point_mlp_bwd(const float* pts, const float* dirs, const float* g_rgb,
                                  const float* g_density, const void* tiles, const void* tiles_dx,
                                  const void* const* biases, void* xops, void* gops,
                                  float* chain_part, float* dw_part, void* scratch, float* grads,
                                  float* dpts, float* ddirs, long long M, int D, int n_ctas,
                                  int chunks, int occ_softplus, int head_dist_alpha, int total,
                                  int* launches, void* stream) {
  const bool wide = D == 384 || D == 512;
  const long long n_pass = (M + (wide ? kWRows : kPts) - 1) / (wide ? kWRows : kPts);
  const long long row_tiles = (M + kPts - 1) / kPts;
  if (M <= 0 || n_ctas <= 0 || n_ctas > n_pass || chunks <= 0 || chunks > row_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((D != 128 && D != 256 && !wide) || total != grad_layout(D).total ||
      (wide && scratch == nullptr))
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
  launches[0] = launches[1] = 0;
  cudaError_t err;
  switch (D) {
    case 512:
      err = launch_bwd_w<512>(pts, dirs, g_rgb, g_density, w, wdx, bias, xo, go, chain_part, sc,
                              dw_part, grads, dpts, ddirs, M, n_ctas, chunks, occ_softplus,
                              head_dist_alpha, launches, st);
      break;
    case 384:
      err = launch_bwd_w<384>(pts, dirs, g_rgb, g_density, w, wdx, bias, xo, go, chain_part, sc,
                              dw_part, grads, dpts, ddirs, M, n_ctas, chunks, occ_softplus,
                              head_dist_alpha, launches, st);
      break;
    case 256:
      err = launch_bwd<256>(pts, dirs, g_rgb, g_density, w, wdx, bias, xo, go, chain_part,
                            dw_part, grads, dpts, ddirs, M, n_ctas, chunks, occ_softplus,
                            head_dist_alpha, launches, st);
      break;
    default:
      err = launch_bwd<128>(pts, dirs, g_rgb, g_density, w, wdx, bias, xo, go, chain_part,
                            dw_part, grads, dpts, ddirs, M, n_ctas, chunks, occ_softplus,
                            head_dist_alpha, launches, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
