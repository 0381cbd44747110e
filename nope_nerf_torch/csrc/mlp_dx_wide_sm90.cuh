// The dX chain at hidden_dim 384 and 512 on Hopper (sm_90a), on the 64-point
// tile of mlp_fwd_wide_sm90.cuh: for the frozen-network backward kernels
// render_bwd_frozen.cu (K4's variant) and point_mlp_bwd_frozen.cu (K6's). It
// does what mlp_dx_sm90.cuh does at 128 and 256: the tile's forward with its
// ReLU masks kept, then every layer's dX = g W back to the cotangent of the
// position encoding, no weight gradient formed. The render kernels' per-ray
// pieces that depend on the tile (the producer, the rgb head's backward, the
// encoding and direction VJPs) close this file; the composite forward and
// backward are mlp_dx_sm90.cuh's, which are per ray. Past 512 the frozen
// variants run mlp_dx_xwide_sm90.cuh's chain (one buffer, passes of 128
// columns, each product summed slice by slice from zero), which takes this
// file's epilogue (store_dx_w), ring_skip, render encoders and direction VJP
// (dir_vjp).
//
// Numerics are those of mlp_dx_sm90.cuh (and of the plain version,
// ops/fused_render.py::mlp_backward), in a fixed order:
// - the forward's, K3's and K5's bits (mlp_fwd_wide_sm90.cuh's
//   mlp_tile_w_masks with its ReLU masks kept: each 32-column slice of K
//   summed from zero, added in f32 to the accumulator that starts at the
//   bias, slice by slice in order);
// - every cotangent rounded to bf16 before it enters a product, each product
//   summed from zero over 16-column steps of K in order, then in the
//   epilogue's order: + gs wd (the density head's rank-1 term), the ReLU
//   mask, the bf16 rounding;
// - the masks from the bf16 activations (bf16(relu(x)) > 0);
// - the rgb head's backward in f32 on the accumulator fragment of the
//   rgb-hidden layer, g_h = (bf16 g_rgb . wo[:, j]) * mask; its column sums
//   (K4's ghsum) over a thread's two rows, then the warp's eight row groups by
//   shfl_xor over 4, 8, 16, then the warpgroup's four warps in order;
// - dpe = g0 W0 summed first, then g4 W5pe into the same accumulator, both by
//   warpgroup 0 (N = 64): the encoding VJPs then sum each row over its lanes
//   by shfl_xor over 1 then 2, and the block sums over the 8 consumer warps
//   in order (warpgroup 1 adds zeros). No atomics: two launches give the same
//   bits.
//
// Design:
// - The CTA is mlp_fwd_wide_sm90.cuh's: two consumer warpgroups and a
//   producer warpgroup, persistent; the producer's first warp streams weight
//   slices through the ring, its other three warps encode the next tile. The
//   ring carries the forward slices (pack_tiles, 32 columns) and then the
//   backward's (pack_tiles_dx at these widths: 32-column slices of each
//   (in, out) weight, the 64-byte swizzle, TilesDxW below).
// - As in the wide forward, the two consumer warpgroups split each product's
//   N, here the layer's inputs: warpgroup g computes columns [gD/2,
//   (g+1)D/2) of the new cotangent for all 64 rows, one wgmma m64nNk16 with
//   N = D/2 per 16 columns of K (the layer's outputs): 96 and 128
//   accumulators a thread. Both read every column of the old cotangent, so
//   two buffers of 64 x D bf16 take turns, one 256-thread barrier a layer.
// - The encoding products (dpe: N = 64 lanes; K6's direction product: N =
//   32) are small: warpgroup 0 runs each whole, and warpgroup 1 waits for
//   their ring slices and releases them (ring_skip). So the encoding VJPs
//   find every lane of a row in one warpgroup, as in the 128-point chain.
// - The ReLU masks do not fit in shared memory at 512 (34 KB a tile beside
//   the two 64 KB buffers, the ring's two 32 KB stages and the heads). The
//   forward's epilogue writes one bit per activation to a per-CTA scratch in
//   device memory, straight from its registers, in the accumulator's own
//   layout (bit i of a thread's words: its accumulator i), and the backward's
//   epilogue of the same layer reads them back in the same thread: 34 KB a
//   tile at 512 (26 KB at 384), which L2 keeps. K4 keeps the masks of every
//   tile of a ray (the composite backward needs the heads of the whole ray
//   before any tile's chain), so no tile runs its forward twice.
// - g4, the skip layer's cotangent, must survive layers 4 to 1, which keep
//   both buffers busy: each warpgroup writes its half of g4 to the per-CTA
//   scratch from the epilogue's registers (64 x D bf16: 64 KB at 512), and
//   the consumers copy it back by cp.async into the free buffer while
//   warpgroup 0 runs g0 W0.
// - The forward and the chain take a Save hook: mlp_fwd_wide_sm90.cuh's
//   NoSaveW, and mlp_dw_chain_sm90.cuh's OperandSaveW in K6 full, which
//   saves each dW operand where the hook is called (X: operator() in the
//   forward; G: grad() after each dX epilogue), drains before the next write
//   over a saved buffer, and has each dX epilogue form its bias gradient's
//   column sums (store_dx_w's SUM), without reordering any sum of the chain.

#pragma once

#include "mlp_dx_sm90.cuh"
#include "mlp_fwd_wide_sm90.cuh"

namespace {

// The backward's weight buffer of ops/fused_render.py::pack_tiles_dx at 384
// and 512, in bytes: 32-column (output) slices of each (in, out) weight, N =
// in rows of 64 bytes, the 64-byte swizzle, in the order the chain consumes
// them: w12 (H/32 slices of 32 rows; K6 only, K4 starts after them), w11 (H/32
// of D rows), w10, w8, w7, w6, w4, w3, w2, w1 (D/32 of D rows each), w0, w5's
// encoding part (D/32 of 64 rows each).
template <int D, bool DIRS>
struct TilesDxW {
  static_assert(D == 384 || D == 512, "the wide chain takes hidden_dim 384 and 512");
  static constexpr int H = D / 2;
  static constexpr int kDir = H / kWSliceCols;
  static constexpr int kFullSlices = H / kWSliceCols + 8 * (D / kWSliceCols);
  static constexpr int kEnc = 2 * (D / kWSliceCols);
  static constexpr int kFirst = DIRS ? 0 : kDir;
  static constexpr int kEnd = kDir + kFullSlices + kEnc;
  static constexpr uint32_t kDirBytes = kDe * kWSliceCols * 2;
  static constexpr uint32_t kFullBytes = D * kWSliceCols * 2;
  static constexpr uint32_t kEncBytes = kPe * kWSliceCols * 2;
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

// The producer's forward and backward slices of one wide tile.
template <int D>
__device__ __forceinline__ void push_forward_w(Feeder& f, const unsigned char* w, int slices) {
  for (int i = 0; i < slices; ++i) f.push(w + TilesW<D>::offset(i), TilesW<D>::bytes(i));
}
template <int D, bool DIRS>
__device__ __forceinline__ void push_backward_w(Feeder& f, const unsigned char* w) {
  using T = TilesDxW<D, DIRS>;
  for (int i = T::kFirst; i < T::kEnd; ++i) f.push(w + T::offset(i), T::bytes(i));
}

// The next `slices` slices of the ring, which the other warpgroup's products
// read: wait until each is in, then release it.
__device__ __forceinline__ void ring_skip(int slices, Ring& ring) {
  const bool leader = (threadIdx.x & 31) == 0;
  for (int s = 0; s < slices; ++s) {
    const uint32_t stage = ring.it % ring.stages;
    mbar_wait(ring.full + 8 * stage, (ring.it / ring.stages) & 1);
    if (leader) mbar_arrive(ring.empty + 8 * stage);
    ++ring.it;
  }
}

// ---- the chain's scratch ---------------------------------------------------------

// g4's parked copy (64 x D bf16, the activation buffer's layout), per CTA.
template <int D>
__host__ __device__ constexpr size_t g4_bytes_w() { return static_cast<size_t>(kWRows) * D * 2; }

// ---- the dX chain ---------------------------------------------------------------

// This warpgroup's columns col0..col0+N-1 of the new cotangent, all 64 rows,
// = bf16(mask * (acc [+ gs wd])) into `out` (a wide buffer); with SAVE also
// to `save` (device memory, the buffer's layout), in the epilogue's order.
// gs: the tile's 64 bf16-valued raw-density cotangents. With SUM, the f32
// column sums of mask * (acc [+ gs wd]) before the rounding (the bias
// gradient's terms) go to red[w][N] (device memory, past L1) for each warp w
// of the warpgroup: over the thread's two rows, then the warp's eight row
// groups by shfl_xor over 4, 8, 16.
template <int N, bool MASK, bool RANK1, bool SAVE, bool SUM = false>
__device__ __forceinline__ void store_dx_w(const float (&acc)[N / 2], unsigned char* out,
                                           int col0, const uint32_t* mask, const float* gs,
                                           const unsigned char* dens_head, unsigned char* save,
                                           float* red = nullptr) {
  constexpr int W = mask_words_w<N>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
  uint32_t bits[W];
  if (MASK) {
#pragma unroll
    for (int k = 0; k < W; ++k) bits[k] = __ldcg(mask + k * kConsumers + threadIdx.x);
  }
  float gs0 = 0.f, gs1 = 0.f;
  if (RANK1) {
    gs0 = gs[row];
    gs1 = gs[row + 8];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
    if (RANK1) {
      const float wd0 = __bfloat162float(*reinterpret_cast<const bf16*>(dens_head + swz(0, col, 1024)));
      const float wd1 =
          __bfloat162float(*reinterpret_cast<const bf16*>(dens_head + swz(0, col + 1, 1024)));
      v0 += gs0 * wd0;
      v1 += gs0 * wd1;
      v2 += gs1 * wd0;
      v3 += gs1 * wd1;
    }
    if (MASK) {
      const uint32_t m = bits[(4 * j) >> 5] >> ((4 * j) & 31);
      if (!(m & 1u)) v0 = 0.f;
      if (!(m & 2u)) v1 = 0.f;
      if (!(m & 4u)) v2 = 0.f;
      if (!(m & 8u)) v3 = 0.f;
    }
    if (SUM) {
      float s0 = v0 + v2, s1 = v1 + v3;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if ((lane >> 2) == 0) {
        __stcg(red + w * N + col - col0, s0);
        __stcg(red + w * N + col - col0 + 1, s1);
      }
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
    *reinterpret_cast<__nv_bfloat162*>(out + swz(row, col, kWBlockBytes)) = lo;
    *reinterpret_cast<__nv_bfloat162*>(out + swz(row + 8, col, kWBlockBytes)) = hi;
    if (SAVE) {   // past L1 (st.global.cg): the forward's biases stay there
      __stcg(reinterpret_cast<unsigned int*>(save + swz(row, col, kWBlockBytes)),
             *reinterpret_cast<const unsigned int*>(&lo));
      __stcg(reinterpret_cast<unsigned int*>(save + swz(row + 8, col, kWBlockBytes)),
             *reinterpret_cast<const unsigned int*>(&hi));
    }
  }
  fence_proxy_async();
}

// One dX layer: out = epilogue(in W) over the next K/32 ring slices, this
// warpgroup's D/2 of each slice's rows; the hook drains before the epilogue
// writes `out` and takes G operand `op` from it once both halves are
// written (grad). Ends with every read of `in` done.
template <int D, int K, bool MASK, bool RANK1, bool SAVE, typename Save>
__device__ __forceinline__ void dx_layer_w(uint32_t in_s, unsigned char* out, Ring& ring,
                                           const uint32_t* mask, const float* gs,
                                           const unsigned char* dens_head, unsigned char* save,
                                           const Save& hook, int op) {
  constexpr int N = D / 2;
  const int wg = threadIdx.x >> 7;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  ring_products_w<N>(acc, in_s, K / kWSliceCols, wg * N * kWSliceCols * 2, ring);
  hook.drain(wg);
  store_dx_w<N, MASK, RANK1, SAVE, Save::kSum>(acc, out, wg * N, mask, gs, dens_head, save,
                                               hook.red_at(op, wg));
  if (SAVE) __threadfence_block();   // g4's device-memory writes, before others read them back
  consumer_sync();
  hook.grad(op, wg, out);
}

// The rgb head's backward for the tile on the rgb-hidden layer's fragment:
// g_h = (bf16 g_rgb . wo[:, j]) * mask, rounded to bf16 into buffer 1 (`act`
// + one buffer), this warpgroup's D/4 columns of every row. grgb: the tile's
// raw-rgb cotangents (64 x 4 f32); mask_h: the tile's rgb-hidden words. With
// ghsum, the bf16 g_h of the tile's rows are summed per column (the thread's
// two rows, the warp's row groups by shfl_xor over 4, 8, 16, then its
// warpgroup's warps in order through red[4][D/2]) and added to ghsum. Starts
// and ends synchronised (both warpgroups), the buffer fenced for wgmma.
template <int D>
__device__ __forceinline__ void rgb_head_bwd_w(unsigned char* act, const float* grgb,
                                               const uint32_t* mask_h,
                                               const unsigned char* rgb_head, float* red,
                                               float* ghsum) {
  constexpr int H = D / 2;
  constexpr int N = D / 4;
  constexpr int W = mask_words_w<N>();
  unsigned char* buf = act + kWRows * D * 2;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
  consumer_sync();   // the forward is done with the buffers, the cotangents are in
  uint32_t bits[W];
#pragma unroll
  for (int k = 0; k < W; ++k) bits[k] = __ldcg(mask_h + k * kConsumers + threadIdx.x);
  float g[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g[r][c] = bf16_round(grgb[4 * (row + 8 * r) + c]);
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = wg * N + 8 * j + 2 * t;
    const uint32_t m = bits[(4 * j) >> 5] >> ((4 * j) & 31);
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
    *reinterpret_cast<__nv_bfloat162*>(buf + swz(row, col, kWBlockBytes)) = lo;
    *reinterpret_cast<__nv_bfloat162*>(buf + swz(row + 8, col, kWBlockBytes)) = hi;
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
  fence_proxy_async();
  consumer_sync();
  if (ghsum != nullptr) {
    for (int c = threadIdx.x; c < H; c += kConsumers)
      ghsum[c] += ((red[c] + red[H + c]) + red[2 * H + c]) + red[3 * H + c];
    consumer_sync();
  }
}

// The dX chain of the tile from g_h (in buffer 1) to the cotangent of the
// position encoding: feat <- h (w11), x7 <- feat (w10, + gs wd, mask x7),
// x_{l-1} <- x_l (w8..w6, w4..w1, masks x6..x0), the buffers taking turns
// (g0 ends in buffer 0), g4 parked in `save` (this CTA's 64 x D bf16), then
// dpe = g0 W0 + g4 W5pe by warpgroup 0 into `dpe` (the m64n64 fragment of
// all 64 rows; warpgroup 1 leaves it zero). masks: the tile's words; gsbf:
// the tile's 64 bf16-valued raw-density cotangents. Ends with warpgroup 0's
// products done; nothing synchronised after them.
template <int D, typename Save = NoSaveW>
__device__ __forceinline__ void dx_chain_w(float (&dpe)[32], unsigned char* act, Ring& ring,
                                           const uint32_t* masks, const float* gsbf,
                                           const unsigned char* dens_head, unsigned char* save,
                                           const Save& hook = Save()) {
  constexpr int H = D / 2;
  constexpr int LW = mask_layer_words_w<D>();
  constexpr uint32_t kBuf = kWRows * D * 2;
  const int wg = threadIdx.x >> 7;
  unsigned char* const buf[2] = {act, act + kBuf};
  const uint32_t act_s = smem_addr(act);
  // g_h (buffer 1) -> g_feat (0) -> g7 (1) -> g6 (0) -> ... -> g0 (0)
  hook.grad(0, wg, buf[1]);
  dx_layer_w<D, H, false, false, false>(act_s + kBuf, buf[0], ring, nullptr, nullptr, nullptr,
                                        nullptr, hook, 1);
  dx_layer_w<D, D, true, true, false>(act_s, buf[1], ring, masks + 7 * LW, gsbf, dens_head,
                                      nullptr, hook, 2);
#pragma unroll 1
  for (int l = 7; l >= 1; --l) {
    const int in = (l & 1);          // g_l lands in buffer l % 2
    const uint32_t in_s = act_s + in * kBuf;
    if (l == 5)
      dx_layer_w<D, D, true, false, true>(in_s, buf[in ^ 1], ring, masks + 4 * LW, nullptr,
                                          nullptr, save, hook, 10 - l);
    else
      dx_layer_w<D, D, true, false, false>(in_s, buf[in ^ 1], ring, masks + (l - 1) * LW,
                                           nullptr, nullptr, nullptr, hook, 10 - l);
  }
  hook.drain(wg);
  // g4 back into buffer 1 by cp.async, while warpgroup 0 runs g0 W0
  {
    constexpr int kChunks = static_cast<int>(g4_bytes_w<D>() / 16);
    const uint32_t dst = act_s + kBuf;
    for (int e = threadIdx.x; e < kChunks; e += kConsumers)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * e),
                   "l"(save + 16 * e)
                   : "memory");
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dpe[i] = 0.f;
  if (wg == 0)
    ring_products_w<64>(dpe, act_s, D / kWSliceCols, 0, ring);   // g0 W0
  else
    ring_skip(D / kWSliceCols, ring);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_proxy_async();
  consumer_sync();
  if (wg == 0)
    ring_products_w<64>(dpe, act_s + kBuf, D / kWSliceCols, 0, ring);   // + g4 W5pe
  else
    ring_skip(D / kWSliceCols, ring);
}

// ---- the render's per-ray pieces at these widths: K4's frozen variant -----------

// The producer warpgroup's encoders (etid: 0..kEncoders-1) of a render
// backward kernel on 64-point tiles: every tile's sample positions of the
// CTA's rays in the consumers' order, o + v*z by explicitly rounded mul and
// add, one forward tile after another.
__device__ __forceinline__ void render_encoder_w(const float* __restrict__ rays,
                                                 const float* __restrict__ z, const Handoff& hand,
                                                 unsigned char* pe, int etid, int n_rays, int S) {
  const int passes = S / kWRows;
  long long tile = 0;
  for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
    float o[3], v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = rays[r * 9 + c];
      v[c] = rays[r * 9 + 3 + c];
    }
    for (int k = 0; k < passes; ++k, ++tile) {
      wait_free(hand.pe_free, tile);
      const float* zt = z + r * S + k * kWRows;
      encode_tile<10, kPe, kWRows>(pe, etid, [&](int p, int c) {
        const float oc = c == 0 ? o[0] : (c == 1 ? o[1] : o[2]);
        const float vc = c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
        return __fadd_rn(oc, __fmul_rn(vc, zt[p]));
      });
      hand_over(hand.pe_full);
    }
  }
}

// The producer warpgroup of a wide render backward kernel (persistent CTA,
// rays blockIdx.x, blockIdx.x + gridDim.x, ...): its first thread loads the
// heads and streams, per ray, the forward slices of its S/64 tiles and then
// each tile's backward slices; warps 1..3 encode every tile's sample
// positions (render_encoder_w).
template <int D>
__device__ __forceinline__ void render_producer_w(const float* __restrict__ rays,
                                                  const float* __restrict__ z,
                                                  const unsigned char* __restrict__ tiles,
                                                  const unsigned char* __restrict__ tiles_dx,
                                                  const Ring& ring, uint32_t heads,
                                                  uint32_t head_bar, const Handoff& hand,
                                                  unsigned char* pe, int n_rays, int S) {
  using T = TilesW<D>;
  const int passes = S / kWRows;
  const long long mine = (n_rays - static_cast<long long>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int etid = threadIdx.x - kConsumers - 32;
  if (threadIdx.x == kConsumers) {
    mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
    bulk_load(heads, tiles + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
    Feeder f{ring};
    for (long long r = 0; r < mine; ++r) {
      for (int p = 0; p < passes; ++p) push_forward_w<D>(f, tiles, T::kRender);
      for (int p = 0; p < passes; ++p) push_backward_w<D, false>(f, tiles_dx);
    }
  } else if (etid >= 0) {
    render_encoder_w(rays, z, hand, pe, etid, n_rays, S);
  }
}

// The tile's position-encoding cotangent (dpe, warpgroup 0's m64n64
// fragment of the 64 rows) through the encoding to the ray: dz's encoding
// part into gz[p0 + m], d_o and d_v summed over the tile (per row, then the
// block in warp order, warpgroup 1's warps adding zeros) and added to
// rsum[0..5]. ray: o | v | dir. Ends synchronised.
__device__ __forceinline__ void tile_enc_vjp_w(const float (&dpe)[32], const float* ray,
                                               const float* fz, float* gz, float* rsum,
                                               float* red, int p0) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // d_o xyz, d_v xyz
  if (warp < 4) {
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int m = 16 * warp + gq + 8 * hrow;
      const float zz = fz[p0 + m];
      float pts[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) pts[c] = __fadd_rn(ray[c], __fmul_rn(ray[3 + c], zz));
      float dzr = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          int c;
          const float tv = enc_lane_grad90(dpe[4 * j + 2 * hrow + hc], pts, 8 * j + 2 * t + hc,
                                           10, &c);
          if (c >= 0) {
            dzr += tv * ray[3 + c];
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
      dzr += __shfl_xor_sync(0xffffffffu, dzr, 1);
      dzr += __shfl_xor_sync(0xffffffffu, dzr, 2);
      if (t == 0) gz[p0 + m] += dzr;
    }
  }
  block_sum90<6>(sums, red);
  if (tid < 6) rsum[tid] += red[tid];
  consumer_sync();
}

// The forward buffer's w12 (the rgb-hidden layer's direction part: one
// half slice, D/2 rows of 64 bytes, the 64-byte swizzle) from device memory
// to `dst` in shared memory, past L1, over the consumer threads.
template <int D>
__device__ __forceinline__ void stage_w12_w(unsigned char* dst, const unsigned char* src) {
  for (int e = threadIdx.x; e < D / 2 * 64 / 16; e += kConsumers)
    reinterpret_cast<uint4*>(dst)[e] = __ldcg(reinterpret_cast<const uint4*>(src) + e);
}

// The direction encoding's cotangent of a ray from a staged w12, whose
// elements are w12_at(j, k) (out j < H, in k < 32): dde = ghsum wrde^T, pulled
// through the encoding to d(dir) into rsum[6..8]. Ends synchronised.
template <int H, typename W12>
__device__ __forceinline__ void dir_vjp(const W12& w12_at, const float* ghsum, const float* ray,
                                        float* rsum, float* red) {
  const int tid = threadIdx.x;
  if (tid < kDe) {
    float dd = 0.f;
#pragma unroll 16
    for (int j = 0; j < H; ++j) dd = fmaf(ghsum[j], __bfloat162float(w12_at(j, tid)), dd);
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
}

// The direction encoding's cotangent, once per ray: w12 staged into `w12`
// (shared memory), dde = (sum_s bf16 g_h) wrde^T, pulled through the
// encoding to d(dir) into rsum[6..8]. Ends synchronised.
template <int D>
__device__ __forceinline__ void ray_dir_vjp_w(unsigned char* w12, const unsigned char* w12_src,
                                              const float* ghsum, const float* ray, float* rsum,
                                              float* red) {
  stage_w12_w<D>(w12, w12_src);
  consumer_sync();
  dir_vjp<D / 2>([&](int j, int k) { return *reinterpret_cast<const bf16*>(w12 + swz64(j, k)); },
                 ghsum, ray, rsum, red);
}

}  // namespace
