// The forward NeRF MLP trunk at hidden_dim 640, 768, 896 and 1024 on Hopper
// (sm_90a): one 64-point tile through the 9-layer MLP with its layer-4 skip,
// the feature and rgb-hidden layers and the f32 heads (mlp_tile_x_masks), the
// forward of every kernel at these widths: render_fwd.cu (K3) and
// point_mlp_fwd.cu (K5) run it without its ReLU masks, and the backward
// kernels are to run it with them. FwdTrunk<D> (mlp_fwd_wide_sm90.cuh) takes
// it at these widths through the explicit specialisations at the end.
//
// Numerics are those of mlp_fwd_wide_sm90.cuh's trunk: bf16 operands, f32
// accumulators that start at the bias, each 32-column span of K summed from
// zero and added in span order (its ring_products_wp, ring_products_x here),
// activations rounded to bf16 after each ReLU, `feat` rounded without one,
// heads f32. How a layer's output columns are cut into passes changes no
// sum.
//
// Why a tile plan of its own. The 64-point trunk at 384 and 512 gives each
// consumer warpgroup D/2 output columns of a layer (D/4 f32 accumulators a
// thread) and keeps two 64 x D activation buffers beside two ring stages of
// D x 32 weights. Past 512 a warpgroup's N passes wgmma's 256, its
// accumulators pass 128 a thread, and at 1024 the two buffers alone take
// 256 KB of the block's 227.
//
// Design:
// - A tile is 64 points in one activation buffer (64 x D bf16, 64-column
//   blocks of 8 KB in the 128-byte swizzle, as mlp_fwd_wide_sm90.cuh's).
// - A D-wide layer runs in D/128 passes of 128 output columns; in each,
//   warpgroup g computes columns [128p + 64g, 128p + 64g + 64) of all 64 rows
//   (N = 64: 32 accumulators a thread), over every 64-column slice of K. The
//   rgb-hidden layer (D/2 wide) runs in as many passes of 64 columns (N = 32).
// - Both warpgroups read every column of the input while the passes run, so
//   no output may go over it until the last pass is done. Every pass but the
//   last stores its bf16 output (the epilogue's own values) to the CTA's
//   staging scratch in device memory, laid out as the buffer is; the last
//   stays in registers until one 256-thread barrier has ended every read of
//   the input. Then each thread stores its last pass and reads its own
//   staged cells back into the buffer: a thread reads only what it wrote, so
//   no other barrier or fence orders the device memory. The staging is 64 x
//   (D - 128) bf16 a CTA, 112 KB at 1024 (14.8 MB over 132 CTAs): it stays
//   in the 50 MB L2.
// - The weights stream through mlp_fwd_sm90.cuh's ring in slices of 64 K
//   columns of one pass's rows (128 x 64 bf16, 16 KB; 64 x 64 for the
//   rgb-hidden layer), in the 128-byte swizzle; warpgroup g reads its half of
//   each slice's rows and sums each slice as two spans of 32 columns
//   (ring_products_x). Slices of 32 columns, one span each, ran 19 to 20%
//   slower on an H100 with the same bits (PERF.md section 6).
//   ops/fused_render.py::pack_tiles lays them out layer by layer, pass by
//   pass (TilesX).
// - Warpgroup 1 computes the density head on x7 before the feature layer's
//   passes, warpgroup 0 the rgb head at the end of the tile; both heads stay
//   resident in shared memory.
// - Shared memory at D = 1024: activations 128 KB, position encodings 8 KB
//   (and K5's direction encodings 8 KB), heads 24 KB, 3 ring stages of 16 KB
//   (2 for K3 at S = 1024), the barriers and the kernels' f32 arrays.
// - The cost: each slice meets 64 points per byte from L2, as at 384 and 512;
//   the staging adds 2 x 64 x (D - 128) bf16 of L2 traffic a layer and tile
//   (11% of the layer's weight bytes at 1024), and reading the staged passes
//   back sits between two layers.

#pragma once

#include "mlp_dx_sm90.cuh"          // wgmma_bf16<32>
#include "mlp_fwd_wide_sm90.cuh"

namespace {

constexpr int kXCols = 128;    // output columns of one pass of a D-wide layer
constexpr int kXHCols = 64;    // ... of the rgb-hidden layer
constexpr int kXSliceCols = 64;   // K columns of one ring slice: two spans of 32

// The tiled weight buffer of ops/fused_render.py::pack_tiles at 640 to 1024,
// in bytes. For each layer in the order a tile runs them, for each pass, its
// rows' 64-column slices:
//   w0 (1 a pass), w1..w3 (D/64), w4 (D/64) then w5 (1), w6..w8 (D/64),
//   w10 (D/64)                                 -- "full" slices, 128 x 64
//   w11 (D/64) then w12 (1: 32 columns, 32 of zeros)
//                                              -- "half" slices, 64 x 64
// then the density head w9 (8 x D) and the rgb head w13 (8 x D/2), each as
// 64-column blocks of 8 rows (1 KB) in the 128-byte swizzle, loaded once per
// CTA. K3 folds w12 into a per-ray bias and streams no w12 slice.
template <int D>
struct TilesX {
  static_assert(D % kXCols == 0 && D > 512 && D <= 1024,
                "the trunk past 512 takes hidden_dim 640, 768, 896 and 1024");
  static constexpr int kPasses = D / kXCols;            // passes of every layer, h's included
  static constexpr int kFull = kXCols * kXSliceCols * 2;
  static constexpr int kHalf = kXHCols * kXSliceCols * 2;
  static constexpr int kPeSlices = kPe / kXSliceCols;
  static constexpr int kK = D / kXSliceCols;            // slices of a D-column K
  static constexpr int kTrunk = kPasses * (2 * kPeSlices + 8 * kK);
  static constexpr int kHidden = kPasses * (kK + 1);    // the rgb-hidden layer's half slices
  static constexpr int kRender = kTrunk + kPasses * kK;
  static constexpr int kPoint = kTrunk + kHidden;
  static constexpr size_t kHeads =
      static_cast<size_t>(kTrunk) * kFull + static_cast<size_t>(kHidden) * kHalf;
  static constexpr int kDensHead = 8 * D * 2;
  static constexpr int kRgbHead = 8 * (D / 2) * 2;
  // The CTA's staging: the buffer's 64-column blocks but the last pass's two.
  static constexpr size_t kStageBytes = static_cast<size_t>(D / 64 - 2) * kWBlockBytes;
  // Slice i of a tile's stream; with w12 (K5) the stream takes w12's slices,
  // without (K3) it skips them.
  __device__ static size_t offset(int i, bool w12) {
    if (i < kTrunk) return static_cast<size_t>(i) * kFull;
    int j = i - kTrunk;
    if (!w12) j += j / kK;
    return static_cast<size_t>(kTrunk) * kFull + static_cast<size_t>(j) * kHalf;
  }
  __device__ static uint32_t bytes(int i) { return i < kTrunk ? kFull : kHalf; }
  // Byte offset of element (j, k) of w12 (out j < D/2, in k < 32): row j % 64
  // of the w12 slice of pass j / 64.
  __device__ static size_t w12(int j, int k) {
    return static_cast<size_t>(kTrunk) * kFull +
           static_cast<size_t>((j / kXHCols) * (kK + 1) + kK) * kHalf + swz(j % kXHCols, k, 0);
  }
};

// acc += A B^T over the next `slices` 64-column slices of the ring (B = this
// warpgroup's rows of each slice, `b_off` bytes into the stage; A from the
// shared address `a`, 64-column blocks kWBlockBytes apart, slice s meeting
// block s), each slice as SPANS spans of 32 columns whose products are summed
// from zero and added to acc in span order by the CUDA cores: the sums of
// ring_products_wp, two spans a ring slice. Each span waits for its own
// products. Releases every slice before it returns.
template <int N, int SPANS>
__device__ __forceinline__ void ring_products_x(float (&acc)[N / 2], uint32_t a, int slices,
                                                uint32_t b_off, Ring& ring) {
  const bool leader = (threadIdx.x & 31) == 0;
  for (int s = 0; s < slices; ++s) {
    const uint32_t stage = ring.it % ring.stages;
    mbar_wait(ring.full + 8 * stage, (ring.it / ring.stages) & 1);
    const uint32_t b = ring.base + stage * ring.stride + b_off;
    const uint32_t as = a + s * kWBlockBytes;
#pragma unroll
    for (int h = 0; h < SPANS; ++h) {
      float t[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) t[i] = 0.f;
      wgmma_fence();
      wgmma_bf16<N>(t, sw128_desc(as + 64 * h), sw128_desc(b + 64 * h));
      wgmma_bf16<N>(t, sw128_desc(as + 64 * h + 32), sw128_desc(b + 64 * h + 32));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] += t[i];
    }
    if (leader) mbar_arrive(ring.empty + 8 * stage);
    ++ring.it;
  }
}

// ReLU masks, for the backward kernels: per layer and pass, one 32-bit word a
// consumer thread (mask_words_w<64>() = mask_words_w<32>() = 1), as
// store_w_mask writes it; x0..x7, then h.
template <int D>
__host__ __device__ constexpr int mask_layer_words_x() { return (D / kXCols) * kConsumers; }

// One pass's output: store_w's bf16 values (with MASKS and a ReLU, also the
// mask) to `buf`, the activation buffer or the staging laid out as it is.
template <int N, bool RELU, bool MASKS>
__device__ __forceinline__ void store_x(const float (&acc)[N / 2], unsigned char* buf, int col0,
                                        uint32_t* mask) {
  if constexpr (RELU)
    store_w_relu<N, MASKS>(acc, buf, col0, mask);
  else
    store_w<N, false>(acc, buf, col0);
}

// Columns col0..col0+N-1 of the buffer back from the staging: each thread the
// cells store_w gave it, which it wrote itself.
template <int N>
__device__ __forceinline__ void unstage_x(unsigned char* buf, const unsigned char* stage,
                                          int col0) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    const uint32_t o0 = swz(row, col, kWBlockBytes), o1 = swz(row + 8, col, kWBlockBytes);
    const unsigned int v0 = __ldcg(reinterpret_cast<const unsigned int*>(stage + o0));
    const unsigned int v1 = __ldcg(reinterpret_cast<const unsigned int*>(stage + o1));
    *reinterpret_cast<unsigned int*>(buf + o0) = v0;
    *reinterpret_cast<unsigned int*>(buf + o1) = v1;
  }
}

// The end of a layer of PASSES passes of `cols` columns: once both
// warpgroups' products are done (every read of the input), the last pass
// from acc and the staged passes into the buffer; ends synchronised, the
// buffer fenced for wgmma. The drain first: a save still reading the input
// finishes before anything goes over it.
template <int N, bool RELU, bool MASKS, int PASSES, typename Save>
__device__ __forceinline__ void layer_end_x(const float (&acc)[N / 2], unsigned char* act,
                                            const unsigned char* stage, int cols,
                                            uint32_t* mask, const Save& save) {
  const int wg = threadIdx.x >> 7;
  save.drain(wg);
  consumer_sync();
  store_x<N, RELU, MASKS>(acc, act, cols * (PASSES - 1) + N * wg, mask + (PASSES - 1) * kConsumers);
#pragma unroll 1
  for (int q = 0; q + 1 < PASSES; ++q) unstage_x<N>(act, stage, cols * q + N * wg);
  fence_proxy_async();
  consumer_sync();
}

// The forward of every kernel at D = 640 to 1024 (mlp_fwd_wide_sm90.cuh's
// mlp_tile_w_masks at 384 and 512): the MLP over one 64-point tile (the CTA's
// tile number `tile`), run by both consumer warpgroups. Position encodings in
// `pe` (one block of 64 rows), the activation buffer at `act` (64 x D bf16),
// the CTA's staging at `stage` (TilesX::kStageBytes of device memory), the
// heads resident at dens_w / rgb_w (shared addresses). Each layer starts from
// its bias; each 32-column span's product is summed from zero and added in
// span order (ring_products_x); the roundings of every width. The
// rgb-hidden layer starts from `hbias` and, when de != 0, adds the product of
// the direction encodings (one block at shared address de, 32 live columns)
// with w12. x_l, feat and h land in the buffer in turn (h in its first D/2
// columns). Raw rgb and density go to hout[4p + 0..3]; ends with every
// product done and hout's rows written, by warpgroup 0 (rgb) and 1
// (density): the caller synchronises the consumers before it reads them.
// Waits for the encodings and frees them after their last product. With
// MASKS (the backward kernels) the ReLU layers' masks go to `masks` (one
// tile's words, 9 mask_layer_words_x, device memory: layer l's pass p at
// masks + l mask_layer_words_x + p kConsumers); `save` is NoSaveW's kind of
// hook (the X operands' part of it), called once a layer is whole in the
// buffer.
template <int D, bool MASKS = true, typename Save = NoSaveW>
__device__ __forceinline__ void mlp_tile_x_masks(const float* const* b, uint32_t pe, uint32_t de,
                                                 unsigned char* act, uint32_t dens_w,
                                                 uint32_t rgb_w, const float* hbias, float* hout,
                                                 const Handoff& hand, long long tile, Ring& ring,
                                                 uint32_t* masks, unsigned char* stage,
                                                 const Save& save = Save()) {
  using T = TilesX<D>;
  constexpr int P = T::kPasses;
  constexpr int N = kXCols / 2;    // a warpgroup's columns of a D-wide pass
  constexpr int H = kXHCols / 2;   // ... of an rgb-hidden pass
  constexpr int LW = mask_layer_words_x<D>();
  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 31) == 0;
  const uint32_t parity = static_cast<uint32_t>(tile & 1);
  const uint32_t act_s = smem_addr(act);
  const uint32_t b_full = wg * N * kXSliceCols * 2;   // the warpgroup's rows of a slice
  const uint32_t b_half = wg * H * kXSliceCols * 2;
  mbar_wait(hand.pe_full, parity);
  save(0, wg, act + (pe - act_s));
  {
    float acc[N / 2];
#pragma unroll 1
    for (int p = 0; p < P; ++p) {   // x0 = relu(pe W0 + b0)
      const int col = kXCols * p + N * wg;
      acc_bias<N>(acc, b[0] + col);
      ring_products_x<N, 2>(acc, pe, T::kPeSlices, b_full, ring);
      if (p + 1 < P) store_x<N, true, MASKS>(acc, stage, col, masks + p * kConsumers);
    }
    layer_end_x<N, true, MASKS, P>(acc, act, stage, kXCols, masks, save);
    save(1, wg, act);
#pragma unroll 1
    for (int l = 1; l < 8; ++l) {   // x_l = relu(x_{l-1} W_l (+ pe W5 at l = 4) + b_l)
      uint32_t* ml = masks + l * LW;
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        const int col = kXCols * p + N * wg;
        acc_bias<N>(acc, b[l] + col);
        ring_products_x<N, 2>(acc, act_s, T::kK, b_full, ring);
        if (l == 4) {
          ring_products_x<N, 2>(acc, pe, T::kPeSlices, b_full, ring);   // the skip
          if (p == P - 1 && leader) mbar_arrive(hand.pe_free);       // pe's last product
        }
        if (p + 1 < P) store_x<N, true, MASKS>(acc, stage, col, ml + p * kConsumers);
      }
      layer_end_x<N, true, MASKS, P>(acc, act, stage, kXCols, ml, save);
      save(1 + l, wg, act);
    }
    if (wg == 1) head_w<D>(act_s, dens_w, b[8], hout, 3, 1);   // on x7, before feat goes over it
#pragma unroll 1
    for (int p = 0; p < P; ++p) {   // feat = x7 W10 + b9, no ReLU
      const int col = kXCols * p + N * wg;
      acc_bias<N>(acc, b[9] + col);
      ring_products_x<N, 2>(acc, act_s, T::kK, b_full, ring);
      if (p + 1 < P) store_x<N, false, false>(acc, stage, col, nullptr);
    }
    layer_end_x<N, false, false, P>(acc, act, stage, kXCols, nullptr, save);
    save(9, wg, act);
  }
  float acc[H / 2];
  uint32_t* mh = masks + 8 * LW;
#pragma unroll 1
  for (int p = 0; p < P; ++p) {   // h = relu(feat W11 (+ de W12) + hbias)
    const int col = kXHCols * p + H * wg;
    acc_bias<H>(acc, hbias + col);
    ring_products_x<H, 2>(acc, act_s, T::kK, b_half, ring);
    if (de != 0) {
      if (p == 0) {
        mbar_wait(hand.de_full, parity);
        save(10, wg, act + (de - act_s));
      }
      ring_products_x<H, 1>(acc, de, 1, b_half, ring);   // de's 32 lanes: the slice's first span
      if (p == P - 1) {
        save.drain(wg);
        if (leader) mbar_arrive(hand.de_free);
      }
    }
    if (p + 1 < P) store_x<H, true, MASKS>(acc, stage, col, mh + p * kConsumers);
  }
  layer_end_x<H, true, MASKS, P>(acc, act, stage, kXHCols, mh, save);
  if (wg == 0) head_w<D / 2>(act_s, rgb_w, b[11], hout, 0, 3);
}

// Shared memory of a kernel past 512, from a 1024-aligned base: the
// activation buffer (64 x D bf16), the position-encoding block (8 KB), an
// optional direction-encoding block, the heads, the ring, then 8-byte
// barriers (kBars) and the kernel's own f32 arrays (LayoutW's members). And
// the CTAs' staging in device memory (TilesX::kStageBytes each), which the
// host sets.
template <int D>
struct LayoutX {
  uint32_t act, pe, de, heads, ring, bars, f32;
  int stages;
  unsigned char* stage;
  __host__ __device__ LayoutX(bool with_de, size_t f32_bytes) : stage(nullptr) {
    act = 0;
    pe = act + kWRows * D * 2;
    de = pe + kWBlockBytes;
    heads = de + (with_de ? kWBlockBytes : 0);
    ring = heads + TilesX<D>::kDensHead + TilesX<D>::kRgbHead;
    const size_t rest = 8 * kBars + f32_bytes + 1024;   // + the alignment slack
    const long long room = static_cast<long long>(kSmemLimit) - ring - static_cast<long long>(rest);
    const long long fit = room / TilesX<D>::kFull;
    stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
    bars = ring + stages * TilesX<D>::kFull;
    f32 = bars + 8 * kBars;
  }
  __host__ __device__ size_t bytes(size_t f32_bytes) const { return f32 + f32_bytes + 1024; }
  __device__ unsigned char* cta_stage() const {
    return stage + static_cast<size_t>(blockIdx.x) * TilesX<D>::kStageBytes;
  }
};

// What K3 and K5 take from the trunk at 640 to 1024 (FwdTrunk's members);
// tile() also takes the CTA's staging (LayoutX::cta_stage).
template <int D>
struct TrunkX {
  using T = TilesX<D>;
  using NoHook = NoSaveW;
  using Layout = LayoutX<D>;
  static constexpr int kRows = kWRows;
  static constexpr size_t kActBytes = static_cast<size_t>(kWRows) * D * 2;
  // mlp_fwd_sm90.cuh's produce over TilesX's stream: K5's (slices ==
  // T::kPoint) with w12's slices, K3's without.
  __device__ static void feed(const unsigned char* w, uint32_t heads, uint32_t head_bar, Ring ring,
                              long long tiles, int slices) {
    const bool w12 = slices == T::kPoint;
    mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
    bulk_load(heads, w + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
    for (long long tile = 0; tile < tiles; ++tile) {
      for (int i = 0; i < slices; ++i) {
        const uint32_t stage = ring.it % ring.stages;
        mbar_wait(ring.empty + 8 * stage, ((ring.it / ring.stages) & 1) ^ 1);
        mbar_expect_tx(ring.full + 8 * stage, T::bytes(i));
        bulk_load(ring.base + stage * ring.stride, w + T::offset(i, w12), T::bytes(i),
                  ring.full + 8 * stage);
        ++ring.it;
      }
    }
  }
  template <typename Save>
  __device__ static void tile(const float* const* b, uint32_t pe, uint32_t de, unsigned char* act,
                              uint32_t dens_w, uint32_t rgb_w, const float* hbias, float* hout,
                              const Handoff& hand, long long t, Ring& ring, const Save& save,
                              unsigned char* stage) {
    mlp_tile_x_masks<D, false>(b, pe, de, act, dens_w, rgb_w, hbias, hout, hand, t, ring, nullptr,
                               stage, save);
  }
  __device__ static float w12(const unsigned char* w, int j, int k) {
    return __bfloat162float(*reinterpret_cast<const bf16*>(w + T::w12(j, k)));
  }
};

template <>
struct FwdTrunk<640, true> : TrunkX<640> {};
template <>
struct FwdTrunk<768, true> : TrunkX<768> {};
template <>
struct FwdTrunk<896, true> : TrunkX<896> {};
template <>
struct FwdTrunk<1024, true> : TrunkX<1024> {};

}  // namespace
