// The dX chain at hidden_dim 640, 768, 896 and 1024 on Hopper (sm_90a), on
// the 64-point tile of mlp_fwd_xwide_sm90.cuh: for the frozen-network
// backward kernels render_bwd_frozen.cu (K4's variant) and
// point_mlp_bwd_frozen.cu (K6's), and for K6 full (point_mlp_bwd_xwide.cu,
// with mlp_dw_chain_sm90.cuh's OperandSaveX as the chain's Save hook). It
// does what mlp_dx_wide_sm90.cuh does at 384 and 512: the tile's forward
// with its ReLU masks kept (mlp_tile_x_masks<D, true>), then every layer's
// dX = g W back to the cotangent of the position encoding; the frozen
// variants pass no hook and form no weight gradient.
//
// Numerics, fixed before the chain's first run on a card: those of the plain
// version (ops/fused_render.py::mlp_backward with want_param_grads=False), in
// a fixed order, no atomics, so two launches give the same bits:
// - the forward's, K3's and K5's bits at these widths (mlp_tile_x_masks);
// - every cotangent rounded to bf16 before it enters a product;
// - each dX product summed as the forward sums: each 64-column ring slice of
//   K (the layer's outputs) as two spans of 32 columns, each span's product
//   summed from zero and added in f32 in span order (ring_products_x), then
//   in the epilogue's order: + gs wd (the density head's rank-1 term), the
//   ReLU mask, the bf16 rounding (mlp_dx_wide_sm90.cuh's store_dx_w). The
//   chains at 128 to 512 sum a dX product over all of K on the tensor cores'
//   accumulator, which truncates: at K = 512 that lands 14.89 ulps from the
//   exact sum, against cuBLAS f32's 6.81 (PERF.md section 7). K reaches 1024
//   here, so the chain takes the forward's sums, whose truncation is on the
//   scale of 32 products. K6 full past 512 runs this chain, and K1 and K4
//   full are to, so their d(points), d(directions), d(rays) and dz are the
//   frozen variants' bit for bit;
// - the masks from the bf16 activations (bf16(relu(x)) > 0);
// - the rgb head's backward in f32, g_h = (bf16 g_rgb . wo[:, j]) * mask; its
//   column sums (K4's ghsum) over a thread's two rows, then the warp's eight
//   row groups by shfl_xor over 4, 8, 16, then the warpgroup's four warps in
//   order;
// - dpe = g0 W0 summed first, then g4 W5pe into the same accumulator, both by
//   warpgroup 0 (N = 64), K6's direction product (N = 32) by warpgroup 0;
//   the encoding VJPs are mlp_dx_wide_sm90.cuh's.
//
// Design (mlp_fwd_xwide_sm90.cuh's answer to the same walls, mirrored):
// - One 64 x D buffer holds the cotangent, as it holds the activations in
//   the forward: two would take 256 KB at 1024, past the block's 227 KB, and
//   a warpgroup's N = D/2 would pass wgmma's 256.
// - Each dX product g_in = g_out W runs in D/128 passes of 128 columns of
//   g_in (the layer's inputs); in each, warpgroup g computes columns [128p +
//   64g, 128p + 64g + 64) of all 64 rows (N = 64: 32 accumulators a thread)
//   over every 64-column slice of K. Every pass but the last is staged in
//   the CTA's scratch in device memory, laid out as the buffer is; the last
//   stays in registers until one 256-thread barrier ends every read of the
//   old cotangent (layer_end_with, unstage_x).
// - The passes are cut as the forward cut its output columns (128 a pass, 64
//   a warpgroup, the same m64n64 fragment), so the thread whose store_w_relu
//   wrote a mask word (mask_layer_words_x: layer l's pass p at l LW + p
//   kConsumers) is the thread whose dX epilogue reads it back: no fence.
// - The weights stream through the forward's ring in 16 KB stages:
//   pack_tiles_dx's slices (TilesDxX below) of each (in, out) weight, 128
//   rows (one pass's inputs) x 64 K columns (outputs) in the 128-byte
//   swizzle, pass by pass in the chain's order; the encodings' products read
//   slices of 64 rows (w0, w5pe) and K6's direction product slices of 32
//   (w12).
// - The encoding products stay whole in warpgroup 0, as at 384 and 512;
//   warpgroup 1 releases their ring slices (ring_skip).
// - g4 is parked in the CTA's scratch from the epilogue's registers (64 x D
//   bf16, 128 KB at 1024). g0 fills the buffer while g0 W0 runs, so g4 comes
//   back by cp.async only after it (the chain's one extra barrier), and g4
//   W5pe runs on it.
// - The scratch a CTA holds: the staging (64 x (D - 128) bf16, 112 KB at
//   1024), g4 (128 KB) and the masks (9 x D/128 KB a tile: 72 KB at 1024; K4
//   keeps every tile of a ray's, K6 one tile's).
//
// Where trouble was expected, and what the build found (PERF.md section 6):
// - Shared memory at 1024 for K4 frozen: activations 128 KB, pe 8 KB, heads
//   24 KB, the fixed f32 arrays 12.6 KB (ghsum, the rgb-hidden bias and the
//   per-warp column sums, 6 x D/2 floats), two 16 KB ring stages; the
//   per-sample arrays (11 S floats) fit beside them up to S = 384 and go to
//   RayPlace's spill scratch above. K6 frozen keeps three stages.
// - The direction VJP stages the forward buffer's w12 slices (D/128 of 8 KB,
//   64 KB at 1024) in the activation buffer between rays (stage_w12_x).
// - The rgb head's backward reads the h masks as the forward's rgb-hidden
//   layer wrote them: D/128 passes of 64 columns, N = 32 a warpgroup.
// - The per-column arrays of D/2 floats (ghsum, the rgb-hidden bias) pass
//   the 256 consumer threads here: every loop over them strides by
//   kConsumers. The chain's first run on a card cleared ghsum by tid < D/2,
//   which left its last D/2 - 256 columns to sum over every ray: d(rays)
//   far off, two launches apart, dz right.
// - The scratch's working set at 1024 and S = 128: 112 + 128 + 144 KB a CTA,
//   50 MB over 132 CTAs, the size of L2.
// - Spills (ptxas): K4 frozen 108 B of stores and 216 of loads at every
//   width (272 B of stack), K6 frozen none.

#pragma once

#include "mlp_dx_wide_sm90.cuh"
#include "mlp_fwd_xwide_sm90.cuh"

namespace {

// The backward's weight buffer of ops/fused_render.py::pack_tiles_dx at 640
// to 1024, in bytes, in the order the chain consumes it: w12 (D/128 slices
// of 32 rows; K6 only, K4 starts after them), then for each of w11, w10, w8,
// w7, w6, w4, w3, w2, w1 and each of its D/128 passes the 64-column slices
// (K/64 of them) of the pass's 128 rows, then w0 and w5's encoding part
// (D/64 slices of 64 rows each). Every slice is a K-major block of 128-byte
// rows in the 128-byte swizzle.
template <int D, bool DIRS>
struct TilesDxX {
  static_assert(D % kXCols == 0 && D > 512 && D <= 1024,
                "the chain past 512 takes hidden_dim 640, 768, 896 and 1024");
  static constexpr int kP = D / kXCols;
  static constexpr int kDir = D / 2 / kXSliceCols;
  static constexpr int kFullSlices = kP * (D / 2 / kXSliceCols) + 8 * kP * (D / kXSliceCols);
  static constexpr int kEnc = 2 * (D / kXSliceCols);
  static constexpr int kFirst = DIRS ? 0 : kDir;
  static constexpr int kEnd = kDir + kFullSlices + kEnc;
  static constexpr uint32_t kDirBytes = kDe * kXSliceCols * 2;
  static constexpr uint32_t kFullBytes = kXCols * kXSliceCols * 2;
  static constexpr uint32_t kEncBytes = kPe * kXSliceCols * 2;
  __device__ static size_t offset(int i) {
    if (i < kDir) return static_cast<size_t>(i) * kDirBytes;
    const size_t dir = static_cast<size_t>(kDir) * kDirBytes;
    if (i < kDir + kFullSlices) return dir + static_cast<size_t>(i - kDir) * kFullBytes;
    return dir + static_cast<size_t>(kFullSlices) * kFullBytes +
           static_cast<size_t>(i - kDir - kFullSlices) * kEncBytes;
  }
  __device__ static uint32_t bytes(int i) {
    return i < kDir ? kDirBytes : (i < kDir + kFullSlices ? kFullBytes : kEncBytes);
  }
};

// The producer's forward (K5's stream with w12, K3's without) and backward
// slices of one tile.
template <int D>
__device__ __forceinline__ void push_forward_x(Feeder& f, const unsigned char* w, bool w12) {
  using T = TilesX<D>;
  const int slices = w12 ? T::kPoint : T::kRender;
  for (int i = 0; i < slices; ++i) f.push(w + T::offset(i, w12), T::bytes(i));
}
template <int D, bool DIRS>
__device__ __forceinline__ void push_backward_x(Feeder& f, const unsigned char* w) {
  using T = TilesDxX<D, DIRS>;
  for (int i = T::kFirst; i < T::kEnd; ++i) f.push(w + T::offset(i), T::bytes(i));
}

// Words of one tile's masks: x0..x7, then h, each mask_layer_words_x.
template <int D>
__host__ __device__ constexpr size_t mask_tile_bytes_x() {
  return sizeof(uint32_t) * 9 * static_cast<size_t>(mask_layer_words_x<D>());
}

// ---- the dX chain ---------------------------------------------------------------

// One dX layer over the buffer at `act`: g_in = epilogue(g_out W), K = the
// layer's outputs (its 64-column slices of each pass's rows come through the
// ring), in D/128 passes; every pass but the last to the staging, the last
// after the barrier that ends every read of g_out. mask: the layer's words
// (pass p at mask + p kConsumers); with SAVE every pass's output also goes to
// `save` (g4's parked copy, the buffer's layout, past L1). The hook (NoSaveW,
// or K6 full's OperandSaveX) drains before the epilogues write the buffer
// (layer_end_with), has each epilogue form pass p's column sums at
// red_pass(op, wg, p) (store_dx_w's SUM, with kSum) and takes G operand `op`
// from the buffer once the layer is whole (grad).
template <int D, int K, bool MASK, bool RANK1, bool SAVE, typename Save = NoSaveW>
__device__ __forceinline__ void dx_layer_x(unsigned char* act, unsigned char* stage, Ring& ring,
                                           const uint32_t* mask, const float* gs,
                                           const unsigned char* dens_head, unsigned char* save,
                                           const Save& hook = Save(), int op = 0) {
  constexpr int P = D / kXCols;
  constexpr int N = kXCols / 2;
  const int wg = threadIdx.x >> 7;
  const uint32_t act_s = smem_addr(act);
  const uint32_t b_off = wg * N * kXSliceCols * 2;   // the warpgroup's rows of a slice
  auto red = [&](int p) -> float* {
    if constexpr (Save::kSum)
      return hook.red_pass(op, wg, p);
    else
      return nullptr;
  };
  float acc[N / 2];
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    ring_products_x<N, 2>(acc, act_s, K / kXSliceCols, b_off, ring);
    if (p + 1 < P)
      store_dx_w<N, MASK, RANK1, SAVE, Save::kSum>(acc, stage, kXCols * p + N * wg,
                                                   mask + p * kConsumers, gs, dens_head, save,
                                                   red(p));
  }
  layer_end_with<N, P>(
      [&](unsigned char* buf, int col) {
        store_dx_w<N, MASK, RANK1, SAVE, Save::kSum>(acc, buf, col, mask + (P - 1) * kConsumers,
                                                     gs, dens_head, save, red(P - 1));
        if (SAVE) __threadfence_block();   // g4's device-memory writes, before others read them
      },
      act, stage, kXCols, hook);
  hook.grad(op, wg, act);
}

// The rgb head's backward for the tile: g_h = (bf16 g_rgb . wo[:, j]) * mask,
// rounded to bf16 into the buffer's first D/2 columns, in the rgb-hidden
// layer's passes (64 columns, this warpgroup's 32 of each: its fragment of
// the forward's m64n32 products, whose mask word it wrote). grgb: the tile's
// raw-rgb cotangents (64 x 4 f32); mask_h: the tile's rgb-hidden words. With
// ghsum, the bf16 g_h of the tile's rows are summed per column (the thread's
// two rows, the warp's row groups by shfl_xor over 4, 8, 16, then its
// warpgroup's warps in order through red[4][D/2]) and added to ghsum. Starts
// and ends synchronised (both warpgroups), the buffer fenced for wgmma.
template <int D>
__device__ __forceinline__ void rgb_head_bwd_x(unsigned char* act, const float* grgb,
                                               const uint32_t* mask_h,
                                               const unsigned char* rgb_head, float* red,
                                               float* ghsum) {
  constexpr int H = D / 2;
  constexpr int P = D / kXCols;
  constexpr int N = kXHCols / 2;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
  consumer_sync();   // the forward is done with the buffer, the cotangents are in
  float g[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g[r][c] = bf16_round(grgb[4 * (row + 8 * r) + c]);
  }
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    const uint32_t bits = __ldcg(mask_h + p * kConsumers + threadIdx.x);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = kXHCols * p + N * wg + 8 * j + 2 * t;
      const uint32_t m = bits >> (4 * j);
      float v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float wo0 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(0, col + h, 1024)));
        const float wo1 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(1, col + h, 1024)));
        const float wo2 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(2, col + h, 1024)));
        v[h] = (m >> h) & 1u ? g[0][0] * wo0 + g[0][1] * wo1 + g[0][2] * wo2 : 0.f;
        v[2 + h] = (m >> (2 + h)) & 1u ? g[1][0] * wo0 + g[1][1] * wo1 + g[1][2] * wo2 : 0.f;
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<__nv_bfloat162*>(act + swz(row, col, kWBlockBytes)) = lo;
      *reinterpret_cast<__nv_bfloat162*>(act + swz(row + 8, col, kWBlockBytes)) = hi;
      if (ghsum != nullptr) {
        float s0 = __low2float(lo) + __low2float(hi), s1 = __high2float(lo) + __high2float(hi);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if ((lane >> 2) == 0) {
          red[w * H + col] = s0;
          red[w * H + col + 1] = s1;
        }
      }
    }
  }
  fence_proxy_async();
  consumer_sync();
  if (ghsum != nullptr) {
    for (int c = threadIdx.x; c < H; c += kConsumers)
      ghsum[c] += ((red[c] + red[H + c]) + red[2 * H + c]) + red[3 * H + c];
    consumer_sync();
  }
}

// The dX chain of the tile from g_h (in the buffer's first D/2 columns) to
// the cotangent of the position encoding: feat <- h (w11), x7 <- feat (w10,
// + gs wd, mask x7), x_{l-1} <- x_l (w8..w6, w4..w1, masks x6..x0), g4
// parked in `g4` (this CTA's 64 x D bf16), then dpe = g0 W0 + g4 W5pe by
// warpgroup 0 into `dpe` (the m64n64 fragment of all 64 rows; warpgroup 1
// leaves it zero). stage: the CTA's staging (TilesX<D>::kStageBytes); masks:
// the tile's words; gsbf: the tile's 64 bf16-valued raw-density cotangents.
// The hook takes the G operands g_h 0, g_feat 1, g7 2, ..., g0 9 (dx_chain_w's
// order) and drains before g4 goes over g0. Ends with warpgroup 0's products
// done; nothing synchronised after them.
template <int D, typename Save = NoSaveW>
__device__ __forceinline__ void dx_chain_x(float (&dpe)[32], unsigned char* act,
                                           unsigned char* stage, Ring& ring,
                                           const uint32_t* masks, const float* gsbf,
                                           const unsigned char* dens_head, unsigned char* g4,
                                           const Save& hook = Save()) {
  constexpr int LW = mask_layer_words_x<D>();
  const int wg = threadIdx.x >> 7;
  const uint32_t act_s = smem_addr(act);
  hook.grad(0, wg, act);   // g_h
  dx_layer_x<D, D / 2, false, false, false>(act, stage, ring, nullptr, nullptr, nullptr, nullptr,
                                            hook, 1);
  dx_layer_x<D, D, true, true, false>(act, stage, ring, masks + 7 * LW, gsbf, dens_head, nullptr,
                                      hook, 2);
#pragma unroll 1
  for (int l = 7; l >= 1; --l) {   // g_{l-1} from g_l
    if (l == 5)
      dx_layer_x<D, D, true, false, true>(act, stage, ring, masks + 4 * LW, nullptr, nullptr, g4,
                                          hook, 10 - l);
    else
      dx_layer_x<D, D, true, false, false>(act, stage, ring, masks + (l - 1) * LW, nullptr,
                                           nullptr, nullptr, hook, 10 - l);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dpe[i] = 0.f;
  if (wg == 0)
    ring_products_x<64, 2>(dpe, act_s, D / kXSliceCols, 0, ring);   // g0 W0
  else
    ring_skip(D / kXSliceCols, ring);
  hook.drain(wg);    // g0's copies have read the buffer
  consumer_sync();   // every read of g0 is done: g4 goes over it
  {
    constexpr int kChunks = static_cast<int>(g4_bytes_w<D>() / 16);
    for (int e = threadIdx.x; e < kChunks; e += kConsumers)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(act_s + 16 * e),
                   "l"(g4 + 16 * e)
                   : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_proxy_async();
  consumer_sync();
  if (wg == 0)
    ring_products_x<64, 2>(dpe, act_s, D / kXSliceCols, 0, ring);   // + g4 W5pe
  else
    ring_skip(D / kXSliceCols, ring);
}

// ---- the render's per-ray pieces at these widths: K4's frozen variant -----------

// The producer warpgroup of a render backward kernel past 512 (persistent
// CTA, rays blockIdx.x, blockIdx.x + gridDim.x, ...): its first thread loads
// the heads and streams, per ray, the forward slices of its S/64 tiles
// (K3's stream) and then each tile's backward slices; warps 1..3 encode
// every tile's sample positions (render_encoder_w).
template <int D>
__device__ __forceinline__ void render_producer_x(const float* __restrict__ rays,
                                                  const float* __restrict__ z,
                                                  const unsigned char* __restrict__ tiles,
                                                  const unsigned char* __restrict__ tiles_dx,
                                                  const Ring& ring, uint32_t heads,
                                                  uint32_t head_bar, const Handoff& hand,
                                                  unsigned char* pe, int n_rays, int S) {
  using T = TilesX<D>;
  const int passes = S / kWRows;
  const long long mine = (n_rays - static_cast<long long>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int etid = threadIdx.x - kConsumers - 32;
  if (threadIdx.x == kConsumers) {
    mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
    bulk_load(heads, tiles + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
    Feeder f{ring};
    for (long long r = 0; r < mine; ++r) {
      for (int p = 0; p < passes; ++p) push_forward_x<D>(f, tiles, false);
      for (int p = 0; p < passes; ++p) push_backward_x<D, false>(f, tiles_dx);
    }
  } else if (etid >= 0) {
    render_encoder_w(rays, z, hand, pe, etid, n_rays, S);
  }
}

// The forward buffer's w12 (the rgb-hidden layer's direction part: one half
// slice of 64 rows, 32 live columns, per pass of that layer) from device
// memory to `dst` in shared memory, the D/128 slices one after the other,
// past L1, over the consumer threads: element (j, k) at w12_x(j, k).
template <int D>
__device__ __forceinline__ void stage_w12_x(unsigned char* dst, const unsigned char* tiles) {
  using T = TilesX<D>;
  constexpr int kChunks = T::kHalf / 16;
  for (int e = threadIdx.x; e < T::kPasses * kChunks; e += kConsumers) {
    const int p = e / kChunks;
    const unsigned char* src = tiles + T::w12(kXHCols * p, 0);   // the pass's slice
    reinterpret_cast<uint4*>(dst)[e] = __ldcg(reinterpret_cast<const uint4*>(src) + e % kChunks);
  }
}
template <int D>
__device__ __forceinline__ uint32_t w12_x(int j, int k) {
  return (j / kXHCols) * TilesX<D>::kHalf + swz(j % kXHCols, k, 0);
}

}  // namespace
